"""The kernels have no gradient rule: under autograd every kernel entry point
raises, on the CPU (the plain version) as on the card, as ``jax.grad`` of the
JAX package's Pallas calls does.  Under ``torch.no_grad`` they run.  The
card's side is in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import ops
from repro_torch.models import model as model_mod


def _calls(requires_grad: bool, device="cpu"):
    """One call of each of the five entry points on small operands on ``device``."""
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g).to(device).requires_grad_(requires_grad)

    a, b = t(3, 4, 4), t(2, 4, 4)
    idx = np.array([0, 1, 2]), np.array([0, 1, 1]), np.array([0, 0, 1])
    run_ptr = torch.tensor([[0, 2, 3]], device=device)
    src = torch.zeros((1, 3), dtype=torch.long, device=device)
    off = torch.tensor([[0, 1, 0]], device=device)
    q, k, v = t(1, 2, 8, 8), t(1, 1, 8, 8), t(1, 1, 8, 8)  # the kernel's least head dim
    return {
        "block_spmm": lambda: ops.block_spmm(a, b, *idx, 2),
        "block_spmm_tensors": lambda: ops.block_spmm_tensors(
            a, b, *ops.task_arrays(*idx, 2, a.device), 2),
        "grouped_gemm_varsize": lambda: ops.grouped_gemm_varsize(t(10, 4), [3, 0, 7], t(3, 4, 5)),
        "fused_block_spmm": lambda: ops.fused_block_spmm(
            a[None, :2], a[None, None, :1], b[None], b[None, None, :1], src, off, src, off,
            run_ptr, 2),
        "flash_attention": lambda: ops.flash_attention(q, k, v),
    }


ENTRY_POINTS = list(_calls(False))


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_raises_under_autograd(name):
    with pytest.raises(TypeError, match="no gradient rule"):
        _calls(True)[name]()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_runs_without_a_graph(name):
    calls = _calls(True)
    with torch.no_grad():
        out = calls[name]()
    assert not out.requires_grad and torch.isfinite(out).all()
    assert torch.equal(_calls(False)[name](), out)  # no input requires grad: runs


def test_flash_train_step_raises_on_its_first_step():
    """The flash path would leave attention out of the gradient: it raises instead."""
    cfg = reduced_config("qwen2-0.5b")
    state = model_mod.init_train_state(cfg, seed=0, device="cpu")
    step = model_mod.make_train_step(cfg, attn_impl="flash", compute_dtype=torch.float32)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    with pytest.raises(TypeError, match="flash_attention has no gradient rule"):
        step(state, {"tokens": tokens})
