"""The port's logger is its own: in a process that imports both packages
(the tests do), the port's level and file sink leave the JAX package's
logging unchanged, and the JAX package's leave the port's."""

from multiverso_tpu.log import Log as JLog
from multiverso_tpu.log import LogLevel as JLevel
from multiverso_tpu_torch.log import Log, LogLevel


def test_port_level_and_sink_leave_the_jax_logger_alone(tmp_path):
    jpath, path = tmp_path / "jax.log", tmp_path / "port.log"
    JLog.reset_log_file(str(jpath))
    # the JAX logger at INFO whatever an earlier test in the process left
    # (a JAX session's -log_level=error stays set after it)
    JLog.reset_log_level(JLevel.INFO)
    Log.reset_log_file(str(path))
    Log.reset_log_level(LogLevel.ERROR)
    try:
        JLog.info("from the JAX package")
        Log.info("from the port, below its level")
        Log.error("from the port")
        JLog.reset_log_level(JLevel.ERROR)
        Log.reset_log_level(LogLevel.INFO)
        Log.info("from the port again")
    finally:
        JLog.reset_log_file("")
        Log.reset_log_file("")
        JLog.reset_log_level(JLevel.INFO)
        Log.reset_log_level(LogLevel.INFO)
    jax_text, port_text = jpath.read_text(), path.read_text()
    assert "from the JAX package" in jax_text
    assert "port" not in jax_text
    assert "below its level" not in port_text
    assert "from the port" in port_text and "again" in port_text
    assert "JAX" not in port_text
