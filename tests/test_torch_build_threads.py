"""The kernel build's bookkeeping that runs without a card: one build of a
library at a time when several threads ask for it (ops/build.py ``build``:
a waiting thread takes the finished library, or builds it itself when
the first build failed), and the device probe's plain version on a CPU
tensor. nvcc is replaced by a stub that writes the library file."""
import threading
import time

import pytest
import torch

from odelib_tpu_torch.model import make_spec
from odelib_tpu_torch.ops import build


def _spec():
    return make_spec(lambda t, y, ps: [ps[0] * y[0]], ("k",), ("y",))


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """nvcc as a stub that sleeps and writes its output file, counting its
    calls; the build root under tmp_path."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        time.sleep(0.2)
        if len(calls) == 1 and getattr(run, "fail_first", False):
            return type("P", (), dict(returncode=1, stdout="",
                                      stderr="stub error"))()
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        return type("P", (), dict(returncode=0, stdout="", stderr=""))()
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    return run, calls


@pytest.mark.parametrize("first_fails", [False, True],
                         ids=["shared", "first-build-fails"])
def test_one_build_of_a_library_at_a_time(stub_nvcc, first_fails):
    run, calls = stub_nvcc
    run.fail_first = first_fails
    sc = [("lognormal", 0.0, False, False)]
    out, errs = [], []

    def ask():
        try:
            out.append(build.library_path(_spec(), scoring=sc))
        except RuntimeError as e:
            errs.append(e)
    threads = [threading.Thread(target=ask) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(calls) == (2 if first_fails else 1)
    assert len(errs) == (1 if first_fails else 0) and len(out) == 4 - len(errs)
    assert len(set(out)) == 1 and out[0].exists()
    assert not build._BUILDING


def test_device_probe_plain_version_on_the_cpu():
    before = dict(build.PROBE_LAUNCHES)
    x = torch.arange(8.0).reshape(2, 4)
    assert torch.equal(build.device_probe(x), x + 1.0)
    assert build.PROBE_LAUNCHES == before
