"""The PyTorch package stands alone: importing all of it in a fresh
interpreter brings in neither jax nor the JAX package nor cv2, its sources
and chip_smoke.py name none of them, importing it builds nothing, and its
entry points refuse to run without a CUDA device unless the caller asks for
the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "psgradientsdf_tpu_torch")


def _modules():
    names = ["psgradientsdf_tpu_torch"]
    for m in pkgutil.walk_packages([PKG], prefix="psgradientsdf_tpu_torch."):
        names.append(m.name)
    return names


def _fresh(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)


def test_import_brings_in_no_jax_and_builds_nothing():
    mods = _modules()
    assert len(mods) > 25 and "psgradientsdf_tpu_torch.ops.rowcopy" in mods
    for new in ("native", "io.png", "io.checkpoint", "parallel.refine",
                "parallel.distributed", "core.resident", "ops.gn", "ops.fuse",
                "ops.residual", "ops.distcg", "ops.normaleq", "ops.albedo",
                "ops.cull", "ops.preprocess", "ops.energy", "ops.distreg",
                "utils.profiling"):
        assert "psgradientsdf_tpu_torch." + new in mods
    code = (
        "import importlib, os, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m == 'psgradientsdf_tpu'\n"
        "             or m.startswith('psgradientsdf_tpu.'))\n"
        "print('BAD', bad)\n"
        "print('TRITON', 'triton' in sys.modules)\n"
        "print('CV2', 'cv2' in sys.modules)\n"
        "from psgradientsdf_tpu_torch import kernels, native\n"
        "print('LIBS', dict(kernels._libs), native._bound)\n"
        "import torch\n"
        "print('TF32', torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)\n"
    )
    proc = _fresh(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BAD []" in proc.stdout
    assert "TRITON False" in proc.stdout
    assert "CV2 False" in proc.stdout
    assert "LIBS {} {}" in proc.stdout                # nothing built or loaded
    assert "TF32 False False" in proc.stdout     # the precision the package pins


def test_sources_name_neither_jax_nor_the_jax_package():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|psgradientsdf_tpu|cv2|PIL)\b(?!_torch)")
    hits = []
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fh:
            for no, line in enumerate(fh, 1):
                if pat.search(line) or "torch.compile" in line or "import triton" in line:
                    hits.append(f"{path}:{no}: {line.strip()}")
    assert not hits, hits


def test_entry_points_refuse_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    from psgradientsdf_tpu_torch import resolve_device
    from psgradientsdf_tpu_torch.ops.normals import build_fals_cache
    import numpy as np

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fals_cache(8, 8, np.eye(3))


def test_cli_defaults_to_the_gpu_and_fails_without_one(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform resolves")
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"input": "%s/", "output": "", "datatype": "tum"}' % tmp_path)
    proc = _fresh(
        "import sys\n"
        "from psgradientsdf_tpu_torch.cli import main\n"
        f"sys.exit(main(['--config_file', {str(cfg)!r}, '--no-refine']))\n")
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def test_kernel_wrappers_raise_on_cuda_tensors_instead_of_falling_back():
    """The wrappers take the plain version only for CPU tensors: the source
    has no try/except around a launch and no branch that sends a CUDA tensor
    to index_select / index_copy_."""
    with open(os.path.join(PKG, "ops", "rowcopy.py")) as fh:
        src = fh.read()
    assert "try:" not in src and "except" not in src
    wrappers = src.split("# the wrappers")[1]
    assert "index_select" not in wrappers and "index_copy_" not in wrappers
    # the two multi-table gathers and the two multi-table scatters (the
    # one-table calls are their one-table case and have no branch of their
    # own)
    assert len(re.findall(r'if \w+\.device\.type == "cpu":', wrappers)) == 4
    # the hand-written kernels, built for sm_90a by nvcc at first use
    with open(os.path.join(PKG, "csrc", "rowcopy.cu")) as fh:
        cu = fh.read()
    for k in ("gather_tables_kernel", "gather_staged_kernel",
              "scatter_winner_kernel", "scatter_tables_kernel"):
        assert re.search(
            r"__global__ void\s+(__launch_bounds__\(\w+\)\s+)?" + k + r"\(", cu), k
    assert "torch/extension.h" not in cu
    with open(os.path.join(PKG, "kernels.py")) as fh:
        assert "arch=compute_90a,code=sm_90a" in fh.read()


@pytest.mark.parametrize("module,kernels", [
    ("gn", ("gn_solve_kernel", "gn_gram_kernel")), ("fuse", ("fuse_rows_kernel",)),
    ("residual", ("residual_pass_kernel", "dist_jacobian_kernel")),
    ("distcg", ("dist_system_kernel", "dist_cg_kernel")),
    ("normaleq", ("pose_tiles_kernel", "light_tiles_kernel", "light_led_kernel")),
    ("albedo", ("albedo_block_kernel",)),
    ("cull", ("cull_compact_kernel",)),
    ("preprocess", ("fals_normals_kernel", "lapm_kernel")),
    ("energy", ("energy_sums_kernel",)),
    ("distreg", ("reg_operators_kernel", "dist_update_kernel"))])
def test_scan_program_wrappers_raise_on_cuda_tensors_instead_of_falling_back(
        module, kernels):
    """ops/gn.py, ops/fuse.py, ops/residual.py, ops/distcg.py,
    ops/normaleq.py, ops/albedo.py, ops/cull.py, ops/preprocess.py,
    ops/energy.py and ops/distreg.py take the plain version
    only for CPU tensors:
    no try/except around a launch, one CPU branch a wrapper, and their
    kernels hand-written in csrc/ with a plain C interface."""
    with open(os.path.join(PKG, "ops", module + ".py")) as fh:
        src = fh.read()
    assert "try:" not in src and "except" not in src
    wrappers = src.split("# the wrapper")[1]
    n_wrappers = len(re.findall(r"^def \w+\(", wrappers, flags=re.M))
    assert n_wrappers >= 1
    assert len(re.findall(r'if \w+\.device\.type == "cpu":', wrappers)) == n_wrappers
    with open(os.path.join(PKG, "csrc", module + ".cu")) as fh:
        cu = fh.read()
    for k in kernels:
        assert re.search(r"__global__ void\s+(__launch_bounds__\([\w, ]+\)\s+)?"
                         + k + r"\(", cu), k
    assert "torch/extension.h" not in cu and 'extern "C"' in cu
