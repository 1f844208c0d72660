"""Import hygiene and the device rule of the PyTorch port.

- every module of ``llava_reward_torch`` and ``chip_smoke`` imports with
  ``jax`` and ``llava_reward_tpu`` made unimportable;
- no file of the port, nor ``chip_smoke.py``, names them in an import;
- an entry point called with its default device on a machine without CUDA
  raises instead of running on the CPU;
- a kernel wrapper handed a tensor on the card launches its kernel or
  raises: it never falls back to the plain version.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "llava_reward_torch"
FORBIDDEN = ("jax", "jaxlib", "llava_reward_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys, importlib, pkgutil\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import llava_reward_torch as P\n"
        "mods = [m.name for m in pkgutil.walk_packages(P.__path__, 'llava_reward_torch.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_port_sources(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {n}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid here")


def test_default_device_raises_without_cuda():
    _no_cuda()
    from llava_reward_torch.core.config import RewardConfig, phi3v_tiny_config
    from llava_reward_torch.core.device import resolve_device
    from llava_reward_torch.evalx.adaptor import RewardAdaptor
    from llava_reward_torch.io.convert import to_torch
    from llava_reward_torch.models import phi3v

    cfg = phi3v_tiny_config()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        RewardAdaptor(cfg, RewardConfig(), {})
    with pytest.raises(RuntimeError, match="cuda"):
        phi3v.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        to_torch({"w": torch.zeros(1).numpy()})
    assert resolve_device("cpu") == torch.device("cpu")


def test_card_tensor_never_takes_the_plain_version(monkeypatch):
    """With the tensor reported as on the card, the wrapper goes to its
    launch path, which rejects a CPU tensor; no plain call is counted."""
    from llava_reward_torch.ops import flash_attention as fa

    monkeypatch.setattr(fa, "on_card", lambda x: True)
    fa.reset_counters()
    qkv = torch.zeros(1, 64, 3 * 2 * 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.direct_attention(qkv, None, None, kv, n_heads=2, head_dim=64, causal=False,
                            sliding_window=None, scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        fa.rope_transpose(qkv, None, None, col_offset=0, n_heads=2, head_dim=64)
    hm = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa._flash_fwd_hm(hm, hm, hm, kv, None, True, None, 0.125, q_len=64)
    assert all(v == 0 for v in fa.PLAIN_CALLS.values())
    assert all(v == 0 for v in fa.LAUNCHES.values())


def test_card_tensor_never_takes_the_plain_w8a8_versions(monkeypatch):
    """The same rule for the W8A8 kernels (B4-B7)."""
    from llava_reward_torch.ops import int8_matmul as im
    from llava_reward_torch.ops import quant_epilogue as qe

    monkeypatch.setattr(qe, "on_card", lambda x: True)
    monkeypatch.setattr(im, "on_card", lambda x: True)
    qe.reset_counters()
    im.reset_counters()
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        qe.rms_quant(x, torch.ones(256, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        qe.silu_mul_quant(x)
    with pytest.raises(ValueError, match="CUDA"):
        qe.row_quant(x)
    with pytest.raises(ValueError, match="CUDA"):
        im.w8a8_matmul(x, torch.zeros(256, 128, dtype=torch.int8), torch.ones(1, 128))
    with pytest.raises(ValueError, match="CUDA"):
        im.int8_matmul_pre(torch.zeros(4, 256, dtype=torch.int8), torch.ones(4, 1),
                           torch.zeros(256, 128, dtype=torch.int8), torch.ones(1, 128))
    for d in (qe.PLAIN_CALLS, qe.LAUNCHES, im.PLAIN_CALLS, im.LAUNCHES):
        assert all(v == 0 for v in d.values())


def test_import_builds_nothing():
    from llava_reward_torch.ops import cuda_lib

    assert cuda_lib._lib is None
    assert {p.name for p in cuda_lib.CSRC.glob("*.cu")} == {
        "flash_attention.cu", "rope_transpose.cu", "quant_epilogue.cu", "int8_matmul.cu"
    }
