"""Guards on the port's boundary and entry points.

* The port (``odigos_tpu_torch/``, its trainer ``training/`` included),
  ``chip_smoke.py`` and the port's tools (``tools/torch_*.py``) import
  nothing of ``jax``, ``flax``, ``optax``, ``orbax`` or ``odigos_tpu``: an
  AST scan of every file, and a fresh interpreter that imports every
  module of the port and then finds none of those in ``sys.modules`` (this
  test process cannot tell: ``tests/conftest.py`` imports jax). The one
  exception is ``tools/torch_import_bundle.py``, which reads the JAX
  package's Orbax bundles and so must import it: it stays outside the
  port, and no file of the port names it.
* Entry points default to CUDA and raise without it; ``chip_smoke.py``
  exits non-zero and prints no result where there is no card.
* ``tools/torch_kernel_ablation.py``'s text edits find their anchors in
  the kernels' current sources.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "odigos_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "odigos_tpu")


IMPORT_TOOL = ROOT / "tools" / "torch_import_bundle.py"


def _port_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        p for p in (ROOT / "tools").glob("torch_*.py") if p != IMPORT_TOOL)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_has_the_slice_modules():
    rel = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for mod in ("pdata/attrstore.py", "pdata/spans.py", "pdata/gen.py",
                "features/featurizer.py", "kernels/attention.py",
                "kernels/embed.py", "kernels/build.py", "kernels/zscore.py",
                "kernels/featurize.py", "kernels/sort.py",
                "kernels/pack.py", "kernels/head.py",
                "kernels/quant.py", "kernels/qgemm.py",
                "kernels/pool.py", "kernels/recon.py",
                "models/layers.py", "models/transformer.py",
                "models/quantized.py", "models/autoencoder.py",
                "models/convert.py", "models/zscore.py",
                "serving/engine.py", "serving/fused.py",
                "serving/sidecar.py", "serving/failover.py",
                "utils/framing.py", "utils/telemetry.py", "wire/codec.py",
                "kernels/autograd.py", "training/__init__.py",
                "training/data.py", "training/trainer.py",
                "training/checkpoint.py", "training/evaluate.py",
                "kernels/ring.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/launch.py",
                "parallel/ring_attention.py", "parallel/sharding.py",
                "parallel/dryrun.py", "parallel/tp.py"):
        assert mod in rel, mod
    for src in ("segment_attention.cu", "span_embed.cu", "zscore.cu",
                "trace_sort.cu", "featurize.cu", "trace_pack.cu",
                "span_head.cu", "quant.cu", "qgemm.cu", "ae_pool.cu",
                "recon_ce.cu", "ln_exact.cuh", "segment_attention_bwd.cu",
                "ln_bwd.cu", "gelu_bwd.cu", "span_embed_bwd.cu",
                "recon_ce_bwd.cu", "ae_pool_bwd.cu", "ring_attention.cu",
                "attention_tiles.cuh"):
        assert (PORT / "kernels" / "csrc" / src).exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_the_bundle_import_tool_stays_outside_the_port():
    """The tool reads Orbax through the JAX package: it imports both, and
    no file of the port (nor ``chip_smoke.py``) imports it."""
    assert {"jax", "odigos_tpu"} <= _imported_roots(IMPORT_TOOL)
    assert not IMPORT_TOOL.is_relative_to(PORT)
    for path in _port_files():
        assert not {"tools", "torch_import_bundle"} & _imported_roots(path)


def test_training_imports_no_jax_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import odigos_tpu_torch.training as t\n"
        "import odigos_tpu_torch.training.trainer, "
        "odigos_tpu_torch.training.checkpoint, "
        "odigos_tpu_torch.training.evaluate, "
        "odigos_tpu_torch.kernels.autograd\n"
        "import json\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"      if m.split('.')[0] in {FORBIDDEN!r})))\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "odigos_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("")
                                       .parts).replace(".__init__", "")
        for p in PORT.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.rstrip('.'))\n"
        "import json\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"      if m.split('.')[0] in {FORBIDDEN!r})))\n")
    # -I: no PYTHONPATH, no user site (no sitecustomize importing jax)
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_entry_points_default_to_cuda():
    import inspect

    from odigos_tpu_torch.models import (QuantizedTraceScorer,
                                         TraceTransformer, ZScoreDetector)
    from odigos_tpu_torch.serving import EngineConfig
    from odigos_tpu_torch.serving.sidecar import build_parser

    assert inspect.signature(TraceTransformer).parameters[
        "device"].default == "cuda"
    assert inspect.signature(ZScoreDetector).parameters[
        "device"].default == "cuda"
    assert inspect.signature(QuantizedTraceScorer).parameters[
        "device"].default == "cuda"
    assert EngineConfig().device == "cuda"
    assert build_parser().parse_args(["--socket", "x"]).device == "cuda"
    from odigos_tpu_torch.training import Trainer

    assert inspect.signature(Trainer).parameters["device"].default == "cuda"


def test_kernel_build_is_keyed_by_source():
    from odigos_tpu_torch.kernels import build

    path = build.library_path("segment_attention")
    assert path.parent == PORT / "kernels" / "build"
    assert path.name.startswith("segment_attention-")
    assert "compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    with pytest.raises(KeyError):
        build.build(["no_such_kernel"])


def _ablation_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_kernel_ablation", ROOT / "tools" / "torch_kernel_ablation.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("kernel", sorted(_ablation_tool().VARIANTS))
def test_ablation_variants_find_their_anchors(kernel):
    """Every text edit of ``tools/torch_kernel_ablation.py`` finds its
    anchor in the kernel's current source (a missing anchor fails the
    tool's run on the card), and its launcher is the one the source
    exports."""
    from odigos_tpu_torch.kernels import build

    tool = _ablation_tool()
    source, launcher = tool.LAUNCHERS[kernel]
    text = (build.CSRC / build.SOURCES[source]).read_text()
    assert f'extern "C" int {launcher}(' in text
    for variant, edits in tool.VARIANTS[kernel].items():
        for anchor in edits:
            assert anchor in text, (variant, anchor[:60])
