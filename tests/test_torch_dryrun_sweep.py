"""Every (arch x shape) cell of the port's dry run gets the JAX package's verdict.

A cell the reference's ``cfg.supports`` rejects is ``skipped`` with the same
reason; a supported one runs its step on fake tensors and is ``ok`` with
finite, positive counts.  The cells run at reduced width (the reduced
config's dims, the cell's batch and sequence) to keep the file short: the
full-width sweep of all 40 cells is ``chip_smoke.py``'s ``dryrun`` phase and
``python -m repro_torch.launch.dryrun --all``.
"""

from __future__ import annotations

import math

import pytest

pytest.importorskip("jax")

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def test_the_port_has_the_reference_cells():
    from repro.configs import ARCH_IDS as J_ARCH_IDS

    assert list(ARCH_IDS) == list(J_ARCH_IDS) and list(SHAPES) == list(J_SHAPES)
    assert sum(j_get_config(a).supports(J_SHAPES[s])[0] for a in ARCH_IDS for s in SHAPES) == 31


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_verdict_equals_the_reference(arch, shape):
    ok, why = j_get_config(arch).supports(J_SHAPES[shape])
    rec = dryrun.lower_cell(arch, shape, cfg_overrides=dryrun.reduced_overrides(arch))
    assert rec["arch"] == arch and rec["shape"] == shape and rec["mesh"] == "16x16"
    if not ok:
        assert rec == dict(arch=arch, shape=shape, mesh="16x16", status="skipped", why=why)
        return
    assert rec["status"] == "ok", rec.get("error")
    for key in ("flops", "bytes", "model_flops", "state_bytes", "peak_bytes", "compute_term_s",
                "memory_term_s"):
        assert math.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["peak_bytes"] >= rec["state_bytes"] and rec["collective_term_s"] is None
    assert rec["bottleneck"] in ("compute", "memory") and rec["extrapolation"] in (
        "exact", "per-period")
