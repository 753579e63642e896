"""utils/profiling.py and the command line's --profile on the CPU: a session
on the CPU alone opens with no warm-up (the spin kernel exists on the card
only), and the command line's trace of a short scan is written whole.  The
card's side (the warm-up's records kept, every gn_solve launch in the
trace) is checked by chip_smoke.py --profile."""

import json
import os

import pytest
import torch

from psgradientsdf_tpu_torch import cli
from psgradientsdf_tpu_torch.utils import profiling

import test_torch_elastic as tel

torch.set_num_threads(1)


@pytest.fixture
def spins(monkeypatch):
    """Counts the warm-up's spin kernels launched (torch.cuda._sleep)."""
    calls = {"n": 0}

    def spin(cycles):
        calls["n"] += 1

    monkeypatch.setattr(torch.cuda, "_sleep", spin)
    return calls


def test_cli_profile_on_the_cpu_writes_its_trace_without_a_warmup(tmp_path, spins):
    data = str(tmp_path / "tum") + "/"
    tel.make_tum_dataset(data)
    out = str(tmp_path / "out") + "/"
    trace_dir = str(tmp_path / "trace")
    rc = cli.main(["--config_file", tel._config(tmp_path, data, out, last=2),
                   "--no-refine", "--platform", "cpu", "--profile", trace_dir])
    assert rc == 0 and spins["n"] == 0
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert len(names) > 100
    assert not [n for n in names if profiling.is_warmup(n)]
    assert any(n.startswith("aten::") for n in names)      # the scan's ops


def test_a_host_session_opens_with_no_warmup(spins):
    written = []
    with profiling.session(cuda=False, on_trace_ready=written.append) as prof:
        torch.ones(8).sum()
    assert spins["n"] == 0 and written == [prof]
    assert profiling.warmup_kept(prof) == 0
    assert any(e.key == "aten::sum" for e in prof.key_averages())
