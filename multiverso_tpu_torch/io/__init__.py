"""I/O layer of the port (counterpart of ``multiverso_tpu/io``): so far the
``MVTA`` array record framing of ``io/stream.py``. URIs, text readers,
checkpoints and the WAL wait for the durability slice (ROADMAP.md Queue 1
item 7)."""

from .stream import read_array, write_array

__all__ = ["read_array", "write_array"]
