"""The port's ``init`` / ``shutdown`` against the JAX package's, on the CPU.

``init(argv, sync=..., updater=...)`` sets ``-sync`` and ``-updater_type``
in both packages (``MV_Init``'s keyword form), and ``shutdown(finalize)``
takes the reference's ``MV_ShutDown(finalize)`` argument in both.
"""

import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.dashboard import Dashboard as JDashboard
from multiverso_tpu.runtime import Session as JSession
from multiverso_tpu_torch.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.runtime import Session as TSession

_FLAGS = {"sync": False, "updater_type": "default"}


@pytest.fixture()
def fresh():
    """Both packages without a session, their flags put back after."""
    for mv, session, dash in ((jmv, JSession, JDashboard),
                              (tmv, TSession, TDashboard)):
        session._instance = None
        dash.reset()
        for key, value in _FLAGS.items():
            mv.set_flag(key, value)
    yield
    for mv, session in ((jmv, JSession), (tmv, TSession)):
        if session._instance is not None:
            session._instance.stop()
        session._instance = None
        for key, value in _FLAGS.items():
            mv.set_flag(key, value)
    tmv.set_flag("device", "cuda")


@pytest.mark.parametrize("kwargs", [dict(updater="sgd"),
                                    dict(updater="momentum_sgd", sync=True),
                                    dict(sync=False)],
                         ids=["updater", "updater+sync", "sync"])
def test_init_keywords_set_the_same_flags(fresh, kwargs):
    jmv.init(["x"], **kwargs)
    tmv.init(["x", "-device=cpu"], **kwargs)
    for key in _FLAGS:
        assert tmv.get_flag(key) == jmv.get_flag(key), key
    if "updater" in kwargs:
        assert tmv.get_flag("updater_type") == kwargs["updater"]
        # a table made in the session takes that updater
        table = tmv.create_table("array", 4)
        assert type(table.updater).__name__ == type(
            jmv.create_table("array", 4).updater).__name__


@pytest.mark.parametrize("finalize", [True, False])
def test_shutdown_takes_finalize(fresh, finalize):
    for mv, argv in ((jmv, ["x"]), (tmv, ["x", "-device=cpu"])):
        mv.init(argv)
        mv.shutdown(finalize=finalize)
    assert not TSession.get().started
    tmv.shutdown(finalize)            # a second stop is a no-op, as in JAX
