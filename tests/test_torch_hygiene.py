"""Import and device hygiene of the PyTorch port.

The port, ``chip_smoke.py`` and the examples' twins
(``examples/*_torch.py``) import neither JAX nor anything of the
``repro`` package, and its entry points run on CUDA unless the caller
asks for the CPU: without CUDA they raise instead of falling back.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'repro' or "
        "k.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_name_no_jax_and_no_repro():
    bad = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\.|"
                     r"from\s+repro\.|from\s+repro\s+import|import\s+repro\s*$)",
                     re.M)
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 20 and len(examples) >= 4
    for path in files:
        hits = bad.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


def test_entry_points_need_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.aggregation import aggregate, aggregate_packed
    from repro_torch.core.compression import (ErrorFeedback, compress,
                                              masked_compress,
                                              reduce_compressed,
                                              reduce_masked)
    from repro_torch.core.secure_agg import (aggregate_masked,
                                             aggregate_masked_packed,
                                             int_mask_offset,
                                             int_repair_correction,
                                             mask_packed, mask_update,
                                             repair_correction)
    from repro_torch.core.streaming import (MaskedF32Sink, ModularSink,
                                            QuantSink, TopkSink)
    from repro_torch.kernels.secure_agg.ops import combine_pytrees
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    zeros = np.zeros(4, np.float32)
    tree = {"w": zeros}
    msg = compress(zeros, "int8")
    masked, _ = masked_compress(zeros, grid=0.01, client_id="a",
                                cohort=["a"], pair_secret=b"s", device="cpu")
    ef = ErrorFeedback("int8")
    ckpt = str(tmp_path / "ckpt")
    # a save writes the tree where it lies: it takes no device
    save_checkpoint(ckpt, {"w": torch.zeros(4)})
    calls = [
        lambda: build_model("fedforecast-100m"),
        lambda: build_model("hymba-1.5b"),
        lambda: build_model("hymba-1.5b", impl="kernel"),
        lambda: serve.setup("hymba-1.5b"),
        lambda: build_model("gemma2-9b", impl="kernel"),
        lambda: build_model("olmoe-1b-7b"),
        lambda: build_model("seamless-m4t-large-v2"),
        lambda: serve.setup("internvl2-2b"),
        lambda: serve.main(["--arch", "minicpm3-4b", "--gen", "2"]),
        lambda: serve.main(["--arch", "hymba-1.5b", "--gen", "2"]),
        lambda: MaskedF32Sink(16),
        lambda: ModularSink(16, mbits=16, grid=0.01),
        lambda: QuantSink(16),
        lambda: TopkSink(16),
        lambda: mask_packed(zeros, "a", ["a", "b"], b"s"),
        lambda: repair_correction(4, "a", ["b"], b"s"),
        lambda: int_mask_offset(4, "a", ["a", "b"], b"s", 16),
        lambda: int_repair_correction(4, "a", ["b"], b"s", 16),
        lambda: aggregate_masked_packed([zeros]),
        lambda: mask_update(tree, "a", ["a", "b"], b"s"),
        lambda: aggregate_masked([tree, tree]),
        lambda: load_checkpoint(ckpt, tree),
        lambda: combine_pytrees([tree, tree], [0.5, 0.5]),
        lambda: aggregate_packed("fedavg", [zeros, zeros]),
        lambda: aggregate("fedavg", [tree, tree]),
        lambda: reduce_masked([masked]),
        lambda: reduce_compressed([msg], [1.0]),
        lambda: ef.step_masked(zeros, weight=1.0, client_id="a",
                               cohort=["a", "b"], pair_secret=b"s"),
        lambda: params_from_numpy({"w": np.zeros(2, np.float32)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asking for the CPU works
    assert build_model("fedforecast-100m", device="cpu").device.type == "cpu"
    assert MaskedF32Sink(16, device="cpu").device.type == "cpu"
    assert ModularSink(16, mbits=16, grid=0.1, device="cpu").device.type \
        == "cpu"
    assert reduce_masked([masked], device="cpu").device.type == "cpu"
    assert reduce_compressed([msg], [1.0], device="cpu").shape == (4,)
    assert aggregate_packed("fedavg", [zeros], device="cpu").shape == (4,)
    masked = [mask_update(tree, c, ["a", "b"], b"s", device="cpu")
              for c in ("a", "b")]
    assert masked[0]["w"].device.type == "cpu"
    assert aggregate_masked(masked, device="cpu")["w"].shape == (4,)
    assert load_checkpoint(ckpt, tree, device="cpu")[0]["w"].device.type \
        == "cpu"


def test_kernel_build_is_not_triggered_by_import():
    from repro_torch.kernels import _build
    from repro_torch.kernels.compressed_agg import kernel as ckernel
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.secure_agg import kernel
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.launch import serve  # noqa: F401
    from repro_torch.models import ssm  # noqa: F401
    for k in (kernel, ckernel, fkernel, skernel):
        assert k._lib.cache_info().currsize == 0
    assert not _build._LIBS
    assert [p.name for p in _build.sources()] == [
        "compressed_agg.cu", "flash_attention.cu", "secure_agg.cu",
        "ssd_scan.cu"]
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_import_check_covers_the_serve_slice():
    mods = _modules()
    for m in ("repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.ssd_scan.ops", "repro_torch.models.ssm",
              "repro_torch.launch.serve", "repro_torch.configs.hymba_1p5b"):
        assert m in mods


def test_import_check_covers_the_model_zoo():
    from repro_torch.configs import list_configs
    mods = _modules()
    for m in ("repro_torch.models.moe", "repro_torch.models.encdec",
              "repro_torch.models.attention", "repro_torch.models.model"):
        assert m in mods
    for arch in list_configs():
        name = arch.replace("-", "_").replace(".", "p")
        assert f"repro_torch.configs.{name}" in mods, arch
    # the reference's eleven and the port's own nemotron-3-nano-30b-a3b
    assert "nemotron-3-nano-30b-a3b" in list_configs()
    assert len(list_configs()) == 12


CONTROL_PLANE = ("metadata", "crypto", "serialization", "telemetry",
                 "transport", "clients", "communicator", "governance",
                 "validation", "jobs", "reporting", "contribution",
                 "streaming", "protocol", "server", "client", "scheduler",
                 "simulation")


def test_import_check_covers_the_control_plane():
    mods = _modules()
    for m in CONTROL_PLANE:
        assert f"repro_torch.core.{m}" in mods


def test_import_check_covers_the_checkpoint_store():
    mods = _modules()
    for m in ("repro_torch.checkpoint", "repro_torch.checkpoint.ckpt"):
        assert m in mods


def test_socket_board_child_runs_the_port_module():
    """``SocketTransportServer`` starts a fresh interpreter on the port's
    ``_serve_main``; that command line, run with an import check in place
    of the accept loop, pulls in neither JAX nor the reference."""
    from repro_torch.core.transport import (SocketTransport,
                                            SocketTransportServer)
    server = SocketTransportServer()
    server.start()
    try:
        argv = Path(f"/proc/{server._proc.pid}/cmdline").read_bytes() \
            .split(b"\0")
        code = argv[argv.index(b"-c") + 1].decode()
        assert code.startswith(
            "from repro_torch.core.transport import _serve_main; ")
        t = SocketTransport((server.host, server.port))
        t.put("runs/x/a", b"payload", "client-a")
        assert t.get("runs/x/a", reader="server") == b"payload"
        t.close()
    finally:
        server.stop()
    check = code.split(";")[0] + "\n" + (
        "import sys\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'repro' or "
        "k.startswith('repro.'))\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", check], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
