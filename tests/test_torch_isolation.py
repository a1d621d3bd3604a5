"""The port stands alone: with JAX, flax, optax, orbax, PyYAML and scp_tpu
shut out of the import system, every module of scp_tpu_torch (the config
reader, the trainer, the codec CLI, the native octree builder and range
coder, OctAttention's model and codec, the metrics and the tools among
them) and chip_smoke imports, a small CPU encode/decode runs, a tiny EHEM
takes a training step, the codec selftest passes (`cli.selftest --device
cpu`, in rans and in staged mode) and the native KD-tree metrics build and
run: each in a child process of its own, with its own deadline.
chip_smoke.py refuses to report success without a card; no source builds
through torch.utils.cpp_extension (which needs ninja and PyTorch's
headers)."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "scp_tpu_torch")

# Every child shuts the blocked packages out of the import system and runs
# with one intra-op thread: under the test run's parallel workers, a child
# with a full OpenMP pool spends each small op waiting at a barrier for
# threads the oversubscribed cores have descheduled (the staged selftest,
# thousands of tiny ops on the host, took 42 s instead of 1 s on 8 busy
# cores).  A stall dumps the child's stack before its deadline.
_PRELUDE = r"""
import faulthandler, importlib, importlib.abc, pkgutil, sys
faulthandler.dump_traceback_later(%(dump_s)d, exit=True)

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "scp_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Refuse())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

import numpy as np
import torch
torch.set_num_threads(1)
import scp_tpu_torch

def cloud(n):
    rng = np.random.default_rng(0)
    r, az, el = rng.uniform(2, 60, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-0.4, 0.2, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], 1)

def narrow_ehem():
    from scp_tpu_torch.models.ehem import EHEM

    torch.manual_seed(0)
    model = EHEM(self_depths=(2, 2), cross_depths=(1,), embed_dim=64, num_heads=4,
                 window_size=64, mlp_ratio=2.0, knn_k=4, static_knn=True, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05)
    return model
"""

_EPILOGUE = r"""
assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
faulthandler.cancel_dump_traceback_later()
print("ISOLATED_OK", RESULT)
"""

_CASES = {
    "imports": r"""
mods = [m.name for m in pkgutil.walk_packages(scp_tpu_torch.__path__, "scp_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
importlib.import_module("chip_smoke")
for m in ("scp_tpu_torch.config", "scp_tpu_torch.train.data", "scp_tpu_torch.train.trainer",
          "scp_tpu_torch.train.checkpoints", "scp_tpu_torch.cli.train",
          "scp_tpu_torch.tools.train_bench_ckpt", "scp_tpu_torch.ops.edgeconv_fused",
          "scp_tpu_torch.cli.codec_common", "scp_tpu_torch.cli.encode",
          "scp_tpu_torch.cli.decode", "scp_tpu_torch.cli.selftest", "scp_tpu_torch.metrics",
          "scp_tpu_torch.native.build", "scp_tpu_torch.native.octree_native",
          "scp_tpu_torch.tools.gene_normals", "scp_tpu_torch.tools.bench",
          "scp_tpu_torch.models.octattention", "scp_tpu_torch.codec.octattn_rans",
          "scp_tpu_torch.codec.octattn_codec", "scp_tpu_torch.ac", "scp_tpu_torch.ac.py_coder",
          "scp_tpu_torch.native.ac_native", "scp_tpu_torch.tools.bench_octattn",
          "scp_tpu_torch.tools.preprocess", "scp_tpu_torch.tools.multi_preproc",
          "scp_tpu_torch.codec.staged", "scp_tpu_torch.utils.profiling",
          "scp_tpu_torch.native.metrics_native", "scp_tpu_torch.tools.test_gene",
          "scp_tpu_torch.tools.psnr_test", "scp_tpu_torch.train.distributed",
          "scp_tpu_torch.tools.dryrun_multichip", "scp_tpu_torch.utils.env",
          "scp_tpu_torch.tools.import_torch_ckpt", "scp_tpu_torch.tools.profile_codec",
          "scp_tpu_torch.tools.precompile", "scp_tpu_torch.tools.scaling_curve"):
    assert m in mods, m
RESULT = len(mods)
""",
    "codec": r"""
from scp_tpu_torch.codec.ehem_codec import EHEMCodec
from scp_tpu_torch.codec.slices import split_levels
from scp_tpu_torch.core.preprocess import preprocess_points

model = narrow_ehem()
sl = split_levels(preprocess_points(cloud(1200), system="spher", qs=60.0 / 255).context,
                  angular=True)
codec = EHEMCodec(model, context_size=128)
stream, bits, _ = codec.encode_to_stream(sl)
codes = codec.decode(codec.new_stream_decoder(stream, len(sl.occ_stream)), sl.max_level,
                     np.array(sl.pos_mm), angular=True, ground_truth=sl.occ_stream,
                     level_sizes=sl.level_sizes)
assert (codes == sl.occ_stream).all()
RESULT = bits
""",
    "train": r"""
from scp_tpu_torch.config import load_config
from scp_tpu_torch.train.trainer import cross_entropy_bits

cfg = load_config("smoke.yaml", "configs")
assert cfg.model.swin.self_depths == [2, 2] and cfg.data.context_size == 64
model = narrow_ehem()
model.train()
rng = np.random.default_rng(0)
label = torch.from_numpy(rng.integers(0, 255, (1, 128)))
data = torch.from_numpy(rng.integers(1, 9, (1, 128, 4, 3)))
loss = cross_entropy_bits(model(data, torch.rand(1, 128, 3)), label)
loss.backward()
assert all(p.grad is not None for p in model.parameters())
RESULT = float(loss)
""",
    "selftest_rans": r"""
from scp_tpu_torch.cli import selftest
assert selftest.main(["--device", "cpu"]) == 0
RESULT = "rans"
""",
    "selftest_staged": r"""
from scp_tpu_torch.cli import selftest
assert selftest.main(["--device", "cpu", "--ehem-mode", "staged"]) == 0
RESULT = "staged"
""",
    "metrics": r"""
from scp_tpu_torch import metrics
pts = cloud(1200)
assert metrics.chamfer(pts, pts + 0.01) > 0
RESULT = "metrics"
""",
}
CASE_DEADLINE_S = 150  # each child; its stack is dumped DUMP_S in
DUMP_S = 120


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    return out


@pytest.mark.parametrize("case", sorted(_CASES))
def test_port_imports_and_codes_with_jax_shut_out(case):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    code = _PRELUDE % {"dump_s": DUMP_S} + _CASES[case] + _EPILOGUE
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=CASE_DEADLINE_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "ISOLATED_OK" in proc.stdout


def test_no_source_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|yaml|scp_tpu)\b(?!_torch)",
                     re.M)
    hits = [p for p in _port_sources() if p.endswith(".py") and pat.search(open(p).read())]
    assert hits == []


def test_no_source_builds_through_cpp_extension():
    hits = [p for p in _port_sources()
            if "cpp_extension" in open(p).read() or "torch/extension.h" in open(p).read()]
    assert hits == []


def _last_line(text):
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py is expected to pass here")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc.stdout)


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script cannot import the port (or finds no card) and fails."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc.stdout)
