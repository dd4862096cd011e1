"""The port's dry run, cost count and roofline against the JAX package's.

``repro_torch.launch.{cost,dryrun,roofline}`` count what one rank's step
does by tracing it (``FakeTensorMode`` for full size, real CPU tensors at
a small one); the reference compiles the step and reads XLA's HLO.  Here,
on the CPU with JAX in process:

* ``model_flops`` and the ring model ``wire_estimate`` equal the
  reference's exactly;
* on the reduced granite at world 1, the fake trace of a train step counts
  the FLOPs and the peak bytes the same counter counts on real tensors,
  exactly, under both dispatch modes;
* the traced prefill's FLOPs lie within 1 % of ``analyze_hlo``'s for the
  same reduced config compiled on one CPU device (found: equal);
* a record's roofline terms are the hand computation on ``H100``'s peaks.

The collective tally at a fake world of 4 against a real gloo run rides
``_torch_zero_child.py`` (``tests/test_torch_zero.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro import training as jtraining
from repro.configs import ASSIGNED, SHAPES
from repro.configs import get_arch as jget_arch
from repro.launch import hlo_analysis
from repro.launch import roofline as jroofline
from repro.models.model import LanguageModel as JLM
from repro.models.model import init_params as jinit_params
from repro.sharding import single_device_plan
from repro_torch.configs import get_arch
from repro_torch.core.platform import H100
from repro_torch.launch import cost, dryrun, roofline

GRANITE = "granite-moe-3b-a800m"


def _granite(get, mode):
    a = get(GRANITE).reduced()
    return a.replace(moe=dataclasses.replace(a.moe, dispatch=mode))


@pytest.mark.parametrize("arch", ASSIGNED)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_equal_the_reference(arch, shape):
    assert roofline.model_flops(arch, shape) == jroofline.model_flops(arch, shape)


@pytest.mark.parametrize("kind", cost.KINDS)
@pytest.mark.parametrize("n", [1, 2, 8, 256])
def test_wire_estimate_equals_the_reference(kind, n):
    for nbytes in (0, 1, 4096, 3 * 1024 ** 3 + 7):
        assert cost.wire_estimate(kind, nbytes, n) == hlo_analysis._wire_estimate(
            kind, nbytes, n)


@pytest.mark.parametrize("mode", ["capacity", "ragged"])
def test_fake_trace_counts_what_real_tensors_count(mode):
    """The same train step (AdamW, remat full, bf16 compute) on fake and on
    real CPU tensors under the balanced routing: FLOPs, peak bytes, bytes
    and the kernels' op counts equal."""
    arch = _granite(get_arch, mode)
    fake = dryrun.trace_step(arch, "train", None, 2, 32, fake=True)
    real = dryrun.trace_step(arch, "train", None, 2, 32, fake=False)
    assert fake["cost"]["flops"] == real["cost"]["flops"] > 0
    assert fake["memory"] == real["memory"]
    assert fake["cost"] == real["cost"]
    assert fake["kernels"] == real["kernels"]
    if mode == "ragged":  # remat full: 2 / 5 / 3 launches a MoE layer
        assert fake["kernels"] == {"ragged_gate_up_silu_f32": 2 * arch.num_layers,
                                   "ragged_matmul_f32": 5 * arch.num_layers,
                                   "ragged_dw_f32": 3 * arch.num_layers}
    mem = fake["memory"]
    assert mem["state_bytes"] >= mem["param_bytes"] + mem["optimizer_bytes"]
    assert mem["peak_bytes"] > mem["state_bytes"]


@pytest.mark.parametrize("mode", ["capacity", "ragged"])
def test_prefill_flops_match_the_reference_hlo(mode):
    """Within 1 % of ``analyze_hlo`` on the reference's prefill step
    compiled for one CPU device (bf16 compute on both sides); the gap
    found is 0."""
    jarch = _granite(jget_arch, mode)
    plan = single_device_plan(jarch)
    b, s = 2, 64
    with plan.mesh:
        params = jinit_params(jarch, jax.random.PRNGKey(0))
        compiled = jax.jit(jtraining.make_prefill_step(JLM(jarch, plan))).lower(
            params, {"tokens": jnp.zeros((b, s), jnp.int32)}).compile()
    want = hlo_analysis.analyze_hlo(compiled.as_text(), 1).flops
    got = dryrun.trace_step(_granite(get_arch, mode), "prefill", None, b, s)["cost"]["flops"]
    assert got == pytest.approx(want, rel=0.01)


def test_roofline_terms_are_the_hand_computation():
    rec = {"status": "ok", "arch": GRANITE, "shape": "train_4k", "chips": 256,
           "cost": {"flops": 4.0e13, "bytes_accessed": 9.0e12, "bytes_large": 2.5e12},
           "collectives": {"total_wire_bytes": 3.0e10, "total_wire_bytes_bf16adj": 3.0e10},
           "memory": {"peak_bytes": 5.0e9}}
    t = roofline.roofline_terms(rec)
    mf = 6.0 * get_arch(GRANITE).active_params() * 256 * 4096
    assert t["compute_s"] == 4.0e13 / 989.4e12
    assert t["memory_s"] == 2.5e12 / 3.35e12
    assert t["collective_s"] == 3.0e10 / 450e9
    assert t["dominant"] == "memory" and t["bound_s"] == t["memory_s"]
    assert t["model_flops"] == mf
    assert t["useful_flops_ratio"] == mf / (4.0e13 * 256)
    assert t["roofline_mfu"] == mf / 256 / 989.4e12 / t["memory_s"]
    assert t["mem_per_device_gb"] == 5.0
    assert (H100.peak_flops, H100.hbm_bw, H100.link_bw) == (989.4e12, 3.35e12, 450e9)
    assert roofline.roofline_terms({**rec, "status": "error"}) is None
    assert "h100" in roofline.header().lower() and "not measured" in roofline.header()


def test_committed_records_are_whole():
    """Each committed record of the granite train_4k cell has what the
    roofline reads, at the reference's grid (256 ranks: ep 8, tp 2, pp 1)."""
    recs = roofline.load_records()
    rec = recs[f"{GRANITE}--train_4k--pod1"]
    assert rec["status"] == "ok" and rec["platform"] == H100.name
    assert (rec["chips"], rec["ep"], rec["tp"], rec["pp"]) == (256, 8, 2, 1)
    assert rec["memory"]["peak_bytes"] <= H100.hbm_bytes and rec["memory"]["fits"]
    for key in ("dispatch_model", "a2a_model", "robustness_model"):
        assert rec[key], key
    assert set(rec["collectives"]["counts"]) <= set(cost.KINDS)
    assert roofline.roofline_terms(rec)["compute_s"] > 0
    assert GRANITE in roofline.table(recs)
