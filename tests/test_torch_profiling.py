"""The package logger, stage timer and trace (odelib_tpu_torch/utils/
profiling.py) against odelib_tpu's: ``get_logger`` attaches one INFO
handler in the reference's format, so the routing lines print as the
reference's do (the same text for the same run, under the package's own
name) where a bare logger printed nothing below WARNING;
``MCMC(profile=True)`` logs the "stage timings:" report and keeps
``last_profile``; ``trace`` writes a trace file Chrome and TensorBoard
load."""
import glob
import io
import json
import logging

import numpy as np
import torch

from odelib_tpu.utils import StageTimer as RefTimer
from odelib_tpu.utils import get_logger as ref_logger
from odelib_tpu_torch.utils import StageTimer, get_logger, trace

from test_torch_hmc_api import both


def test_logger_is_configured_once_as_the_reference():
    a, b = get_logger(), get_logger()
    assert a is b and a.name == "odelib_tpu_torch"
    assert len(a.handlers) == 1 and a.level == logging.INFO
    ref = ref_logger()
    assert a.handlers[0].formatter._fmt == ref.handlers[0].formatter._fmt \
        == "[%(name)s] %(message)s"
    assert type(a.handlers[0]) is type(ref.handlers[0])


def test_stage_timer_report_is_the_reference():
    got, ref = StageTimer(), RefTimer()
    for t in (got, ref):
        with t.stage("a"):
            pass
        with t.stage("a"):
            pass
        t.times.update({"b": 1.25, "chains[xla]": 3.5})
    assert set(got.times) == {"a", "b", "chains[xla]"}
    got.times["a"] = ref.times["a"] = 0.5
    lines = io.StringIO()
    h = logging.StreamHandler(lines)
    log = logging.getLogger("odelib_tpu_torch.test_timer")
    log.addHandler(h)
    log.propagate = False
    try:
        msg = got.report(log)
    finally:
        log.removeHandler(h)
    assert msg == ref.report(logging.getLogger("odelib_tpu.test_timer"))
    assert lines.getvalue() == msg + "\n"
    assert msg.splitlines()[0] == "stage timings:"


def _printed(logger, fn):
    """What ``logger``'s own handler prints while ``fn()`` runs."""
    h = logger.handlers[0]
    out = io.StringIO()
    old = h.setStream(out)
    try:
        fn()
    finally:
        h.setStream(old)
    return out.getvalue().splitlines()


def test_routing_lines_print_as_the_reference():
    """A scan PT run (eight chains from explicit starts, a multiple of
    the test setting's eight CPU devices, over which the reference spreads
    its chains) prints the reference's swap-rate line through the
    package's own handler; a profiled run also prints the stage timings
    and keeps last_profile."""
    ref_fw, fw = both()
    f = np.exp(np.random.default_rng(0).normal(0, 0.03, (8, 3)))
    run = dict(chain_inits=[dict(mu=0.6 * a, phi=2.4e-8 * b, beta=24.0 * c)
                            for a, b, c in f],
               iterations_per_chain=6, sampler="pt",
               temperatures=(1.0, 2.0), backend="xla", print_report=False)
    ref = _printed(ref_logger(), lambda: ref_fw.MCMC(route="device", **run))
    got = _printed(get_logger(), lambda: fw.MCMC(**run))
    assert ref and got == [ln.replace("[odelib_tpu]", "[odelib_tpu_torch]")
                           for ln in ref]
    assert got[0].startswith("[odelib_tpu_torch] parallel tempering: mean "
                             "swap acceptance")
    got = _printed(get_logger(), lambda: fw.MCMC(profile=True, **run))
    assert got[0].startswith("[odelib_tpu_torch] parallel tempering")
    assert got[1] == "[odelib_tpu_torch] stage timings:"
    stages = list(fw.last_profile)
    assert stages == ["seeding", "chains[pt]", "posterior", "report"]
    assert [ln.split()[0] for ln in got[2:]] == stages


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        x = torch.ones(64, dtype=torch.float64)
        (x * 2.0 + 1.0).sum()
    files = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)
