"""The PyTorch port stands alone: no JAX, nothing of ``buffalo_tpu``.

``buffalo_tpu_torch`` and ``chip_smoke.py`` must import neither ``jax``
nor the reference package (``buffalo_tpu`` / ``buffalo_tpu.*``), so the
port runs on a machine that has neither; and its entry points never
fall back from a requested CUDA device to the CPU.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(ROOT.glob("buffalo_tpu_torch/**/*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    """jax / jax.*, buffalo_tpu / buffalo_tpu.* — but not the port's own
    ``buffalo_tpu_torch``, which merely shares the prefix."""
    return any(module == top or module.startswith(top + ".")
               for top in ("jax", "buffalo_tpu"))


def test_forbidden_prefix_rule():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("buffalo_tpu") and _forbidden("buffalo_tpu.ops.topk")
    assert not _forbidden("buffalo_tpu_torch")
    assert not _forbidden("buffalo_tpu_torch.ops.als_kernels")
    assert not _forbidden("jaxlib_like") and not _forbidden("numpy")


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, buffalo_tpu_torch, buffalo_tpu_torch.convert; "
            "import buffalo_tpu_torch.ops.als_kernels; "
            "import buffalo_tpu_torch.ops.retrieval_kernels; "
            "import buffalo_tpu_torch.parallel.base; "
            "import buffalo_tpu_torch.parallel.ann; "
            "import buffalo_tpu_torch.ops.sgd_kernels; "
            "import buffalo_tpu_torch.models.bpr; "
            "from buffalo_tpu_torch import BPRMF, BPRMFOption, ParBPRMF; "
            "import buffalo_tpu_torch.ops.warp_kernels; "
            "import buffalo_tpu_torch.ops.eals_kernels; "
            "import buffalo_tpu_torch.models.warp; "
            "import buffalo_tpu_torch.models.eals; "
            "from buffalo_tpu_torch import (WARP, WARPOption, EALS, "
            "EALSOption, ParEALS); "
            "import buffalo_tpu_torch.ops.plsi_kernels; "
            "import buffalo_tpu_torch.ops.cfr_kernels; "
            "import buffalo_tpu_torch.data.stream; "
            "from buffalo_tpu_torch import (PLSI, PLSIOption, CFR, "
            "CFROption, ParCFR, Stream, StreamOptions); "
            "import buffalo_tpu_torch.ops.w2v_kernels; "
            "import buffalo_tpu_torch.models.w2v; "
            "from buffalo_tpu_torch import W2V, W2VOption, ParW2V, aux; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'buffalo_tpu' "
            "or m.startswith('buffalo_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_cuda_default_without_card_raises(monkeypatch):
    from buffalo_tpu_torch import ALS, ALSOption

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = ALSOption().get_default_option()
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ALS(opt)
    opt.device = "cpu"
    assert ALS(opt).device.type == "cpu"


def test_retrieval_default_without_card_raises(monkeypatch):
    import numpy as np

    from buffalo_tpu_torch.ops.topk import batch_topn, matmul_topk, topk
    from buffalo_tpu_torch.parallel import IVFIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scores = np.arange(12, dtype=np.float32).reshape(3, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topk(scores, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        matmul_topk(scores, scores, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_topn(scores, scores, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IVFIndex.build(scores, n_clusters=2)
    assert batch_topn(scores, scores, 2, device="cpu")[0].tolist() == \
        [[2, 1]] * 3
    assert topk(scores, 2, device="cpu").tolist() == [[3, 2]] * 3
    assert matmul_topk(scores, scores, 2, device="cpu")[1].device.type == \
        "cpu"


def test_bpr_cuda_default_without_card_raises(monkeypatch):
    from buffalo_tpu_torch import BPRMF, BPRMFOption

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = BPRMFOption().get_default_option()
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BPRMF(opt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BPRMF.instantiate(BPRMFOption, "unused", [], device="cuda")
    opt.device = "cpu"
    assert BPRMF(opt).device.type == "cpu"


def test_bpr_kernel_modules_covered():
    """The BPR modules are among the files the import rule checks."""
    names = {p.name for p in PORT_FILES}
    assert {"sgd_kernels.py", "bpr.py"} <= names


@pytest.mark.parametrize("name", ["WARP", "EALS"])
def test_warp_and_eals_cuda_default_without_card_raises(monkeypatch, name):
    import buffalo_tpu_torch as port

    cls, opt_cls = getattr(port, name), getattr(port, name + "Option")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = opt_cls().get_default_option()
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(opt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls.new("unused", device="cuda")
    opt.device = "cpu"
    assert cls(opt).device.type == "cpu"


def test_warp_and_eals_modules_covered():
    """The WARP and eALS modules are among the files the import rule
    checks."""
    names = {p.name for p in PORT_FILES}
    assert {"warp_kernels.py", "warp.py", "eals_kernels.py",
            "eals.py"} <= names


@pytest.mark.parametrize("name", ["PLSI", "CFR"])
def test_plsi_and_cfr_cuda_default_without_card_raises(monkeypatch, name):
    import buffalo_tpu_torch as port

    cls, opt_cls = getattr(port, name), getattr(port, name + "Option")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = opt_cls().get_default_option()
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(opt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls.new("unused", device="cuda")
    opt.device = "cpu"
    assert cls(opt).device.type == "cpu"


def test_plsi_stream_and_cfr_modules_covered():
    """The pLSI, Stream and CoFactor modules are among the files the
    import rule checks."""
    names = {p.name for p in PORT_FILES}
    assert {"plsi_kernels.py", "plsi.py", "cfr_kernels.py", "cfr.py",
            "stream.py"} <= names


def test_w2v_cuda_default_without_card_raises(monkeypatch):
    from buffalo_tpu_torch import W2V, W2VOption

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = W2VOption().get_default_option()
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        W2V(opt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        W2V.new("unused", device="cuda")
    opt.device = "cpu"
    assert W2V(opt).device.type == "cpu"


def test_w2v_modules_covered():
    """The W2V modules are among the files the import rule checks."""
    names = {p.name for p in PORT_FILES}
    assert {"w2v_kernels.py", "w2v.py"} <= names


def test_exports_match_the_reference():
    """The package exports the JAX package's names, W2V's and the
    reference's compatibility flags included (both False)."""
    import buffalo_tpu
    import buffalo_tpu_torch

    assert sorted(buffalo_tpu_torch.__all__) == sorted(buffalo_tpu.__all__)
    for name in buffalo_tpu_torch.__all__:
        assert hasattr(buffalo_tpu_torch, name), name
    assert buffalo_tpu_torch.inited_CUALS is False
    assert buffalo_tpu_torch.inited_CUBPR is False
