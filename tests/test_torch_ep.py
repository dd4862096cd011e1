"""The port's expert parallelism against the JAX package's sharded MoE.

``_torch_ep_child.py`` runs both sides, once for the module: the JAX
package's ``moe_ffn`` on a (2, 4) mesh of 8 fake host devices and its
single-device model (``granite-moe-3b-a800m.reduced()``: 8 experts top-2,
so ep = gcd(8, 4) = 4), then the port on gloo ranks of the CPU (8 ranks,
then 4 for serving; ``spawn`` and a ``file://`` rendezvous, no port).
Capacity factor 16 wherever no drop may occur, 1.25 for the rank-budget
overflow case.

Tolerances.  Forward: 1e-5 (fp32, summation order).  Gradients: 1e-4.  The
dispatch/combine payload crosses the all-to-all in bf16 both ways (the
reference's ``_transport_bf16``), and a last-bit fp32 difference between
the two sides can round an element the other way: one bf16 step, 2^-7 of
the payload's scale, carried through the expert GEMMs.  So ``close_wire``
lets at most 1 % of the elements exceed the tolerance, each by no more than
2^-7 of the tensor's largest magnitude (measured: 0.1 % of dx, worst 0.066
of that bound; the overflow case's forward 0.01 %, 0.32).  The model-level
gates are the reference's own ``check_moe_ep`` gates (loss 2e-3, grads
2e-3, the embedding at relative 0.05), and beside them every leaf's largest
gap is held to ``GRAD_REL`` = 0.02 of its largest magnitude: the reduced
model's gradients are below 1.3e-2, so the element-wise 2e-3 alone passes a
halved expert gradient, and the bf16 wire's rounding (2^-8 = 3.9e-3 of an
element) gives 2.1e-3 to 6.8e-3 measured.  The train step's loss is held
to world 1 at 1e-3 (``sharded_train_matches``), its grad norm and first
moment at ``GRAD_REL``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import halo as jhalo
from repro.sharding import choose_ep as jchoose_ep
from repro_torch import sharding
from repro_torch.configs import get_arch
from repro_torch.convert import shard_params
from repro_torch.core import halo
from repro_torch.launch import ranks
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import moe as tmoe
from repro_torch.models.model import init_params
from repro_torch.serving import Engine, ServeConfig
from repro_torch.serving.engine import check_ep

from _torch_ep_child import LAUNCH_ARGS

CHILD = Path(__file__).with_name("_torch_ep_child.py")
SRC = Path(__file__).resolve().parents[1] / "src"
MESH, B, S, MODES, CHUNKS = (2, 4), 8, 16, ("capacity", "ragged"), (1, 3)
BL, SL = B // MESH[0], S // MESH[1]
FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4
GRAD_REL = 0.02  # a leaf's largest gap over its largest magnitude (docstring)


def _run(args, env=None):
    proc = subprocess.run([sys.executable, str(CHILD)] + args, capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(SRC), **(env or {})})
    assert proc.returncode == 0, proc.stdout[-4000:] + "\n" + proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    ref_path = str(d / "ref.npz")
    _run(["jax", ref_path], {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
                             "JAX_PLATFORMS": "cpu"})
    out = _run(["port", ref_path, str(d)])
    ref = dict(np.load(ref_path))
    layers = [dict(np.load(d / f"layers_rank{r}.npz")) for r in range(8)]
    serve = [dict(np.load(d / f"serve_rank{r}.npz")) for r in range(4)]
    return ref, layers, serve, out


def block(a, r):
    """Device (i, j) of the (2, 4) mesh: batch shard i, sequence shard j."""
    i, j = divmod(r, MESH[1])
    return a[i * BL:(i + 1) * BL, j * SL:(j + 1) * SL]


def expert_slice(a, r):
    e = r % MESH[1]
    return a[e * 2:(e + 1) * 2]  # E_l = 8 / 4


def close_wire(got, want, atol):
    """Within ``atol`` but for at most 1 % of the elements, which the bf16
    wire may have rounded one step the other way (module docstring)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = atol + 2.0 ** -7 * float(np.abs(want).max())
    assert err.max() <= bound, (err.max(), bound)
    assert (err > atol).mean() <= 0.01, (err > atol).mean()


# ---------------------------------------------------------------------------
# Against the JAX package's sharded moe_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", CHUNKS)
@pytest.mark.parametrize("mode", MODES)
def test_moe_ffn_matches_reference_per_device_block(runs, mode, K):
    ref, layers, _, _ = runs
    t = f"fwd/{mode}/K{K}"
    for r, res in enumerate(layers):
        np.testing.assert_allclose(res[f"{t}/y"], block(ref[f"{t}/y"], r), rtol=0,
                                   atol=FWD_ATOL)
        for k in ("moe_aux_loss", "moe_z_loss", "expert_load"):
            np.testing.assert_allclose(res[f"{t}/{k}"], ref[f"{t}/{k}"], rtol=0, atol=1e-6)
        close_wire(res[f"{t}/dx"], block(ref[f"{t}/dx"], r), GRAD_ATOL)
        close_wire(res[f"{t}/dw_router"], ref[f"{t}/dw_router"], GRAD_ATOL)
        for k in ("w_up", "w_gate", "w_down"):
            close_wire(res[f"{t}/d{k}"], expert_slice(ref[f"{t}/d{k}"], r), GRAD_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_chunked_a2a_equals_monolithic(runs, mode):
    """chunks = 3 (a tail chunk) against chunks = 1: the forward bit for
    bit, every gradient within 1e-5 (the reference's check_a2a_chunked)."""
    _, layers, _, _ = runs
    for res in layers:
        assert np.array_equal(res[f"fwd/{mode}/K3/y"], res[f"fwd/{mode}/K1/y"])
        for k in ("dx", "dw_router", "dw_up", "dw_gate", "dw_down"):
            np.testing.assert_allclose(res[f"fwd/{mode}/K3/{k}"], res[f"fwd/{mode}/K1/{k}"],
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_decode_matches_reference(runs, mode):
    """Weight-parallel decode at ep = 4 (tokens replicated over the EP
    group, batch-sharded over data): no wire cast, check_ragged_ep's 1e-5;
    the metrics meaned over the data group only."""
    ref, layers, _, _ = runs
    t = f"decode/{mode}"
    for r, res in enumerate(layers):
        i = r // MESH[1]
        np.testing.assert_allclose(res[f"{t}/y"], ref[f"{t}/y"][i * BL:(i + 1) * BL],
                                   rtol=0, atol=1e-5)
        for k, tol in (("moe_aux_loss", 1e-6), ("moe_z_loss", 1e-6), ("expert_load", 1e-3)):
            np.testing.assert_allclose(res[f"{t}/{k}"], ref[f"{t}/{k}"], rtol=0, atol=tol)


def test_rank_budget_overflow_matches_reference(runs):
    """Ragged at cf 1.25 on skewed tokens: rows past a destination's
    E_l * C budget are dropped (the output differs from the dropless local
    layer's), and the same rows as the reference's."""
    ref, layers, _, _ = runs
    got = np.stack([res["overflow/y"] for res in layers])
    want = np.stack([block(ref["overflow/y"], r) for r in range(8)])
    close_wire(got, want, FWD_ATOL)
    dropped = max(np.abs(res["overflow/y"] - res["overflow/y_local"]).max() for res in layers)
    assert dropped > 0.1, dropped


@pytest.mark.parametrize("ep", [2, 4, 8])
def test_halo_equals_flat(runs, ep):
    """The bare all-to-all (against its definition too) and its gradient,
    exact; HALO has two phases only at ep = 8 (g1 = 4), where the ragged
    layer's output and gradients are exact too."""
    _, layers, _, _ = runs
    for res in layers:
        assert res[f"halo/ep{ep}/def_ok"] and res[f"halo/ep{ep}/y_eq"]
        assert res[f"halo/ep{ep}/g_eq"]
        assert int(res[f"halo/ep{ep}/g1"]) == (4 if ep == 8 else 1)
        if ep == 8:
            assert res["halo/ep8/layer_eq"]


# ---------------------------------------------------------------------------
# Model, train step, serving and launchers over ranks
# ---------------------------------------------------------------------------


def grad_gate_failures(got, want):
    """The leaves of a gradient tree ({path: array}) that fail the gates
    against ``want``: check_moe_ep's (2e-3 element-wise, the embedding at
    relative 0.05 in norm) and, on every leaf, ``GRAD_REL`` of its largest
    magnitude (the element-wise gate alone cannot see a halved gradient
    whose elements are below 4e-3)."""
    bad = []
    for k, w in want.items():
        gap = np.abs(got[k] - w)
        if k.endswith("/embed"):
            ok = np.linalg.norm(got[k] - w) / (np.linalg.norm(w) + 1e-9) < 0.05
        else:
            ok = gap.max() < 2e-3
        if not (ok and gap.max() <= GRAD_REL * np.abs(w).max()):
            bad.append(k)
    return bad


@pytest.mark.parametrize("mode", MODES)
def test_model_loss_and_grads_match_world_1(runs, mode):
    """Loss and gathered gradients at (2, 4) against the port's world-1
    run and the JAX package's single-device model, at check_moe_ep's gates
    and ``GRAD_REL``, which a halved expert gradient fails; every rank holds
    the same reduced gradients."""
    ref, layers, _, _ = runs
    r0 = layers[0]
    assert abs(float(r0[f"model/{mode}/loss"]) - float(r0[f"model1/{mode}/loss"])) < 2e-3
    assert abs(float(r0[f"model/{mode}/loss"]) - float(ref[f"model/{mode}/loss"])) < 2e-3
    pre = f"model/{mode}/grad/"
    got = {k[len(pre):]: v for k, v in r0.items() if k.startswith(pre)}
    assert sorted(got) == sorted(k[len(pre):] for k in ref if k.startswith(pre))
    for want in ({k: r0[f"model1/{mode}/grad/{k}"] for k in got},
                 {k: ref[pre + k] for k in got}):
        assert grad_gate_failures(got, want) == []
        experts = sharding.expert_paths(got)
        halved = {k: v * (0.5 if k in experts else 1.0) for k, v in got.items()}
        assert sorted(grad_gate_failures(halved, want)) == sorted(experts)
    for k in got:
        for res in layers[1:]:
            assert np.array_equal(res[pre + k], r0[pre + k]), k


def test_sharded_train_step_matches_world_1(runs):
    """One AdamW step at (2, 4) against world 1: the loss
    (``sharded_train_matches``), the global grad norm the clip uses (within
    ``GRAD_REL``; measured 2.2e-4), and the gathered state after the update.
    The first moment is (1 - b1) x the clipped gradient, so it is held per
    leaf at ``GRAD_REL`` of its largest magnitude (measured 6.6e-3, the bf16
    wire).  At step 1 AdamW moves an element by lr x m/(|m| + eps), so two
    runs differ by at most 2 lr where a tiny gradient's sign differs: the
    params are held there, and at most 1 % of the elements of a leaf may
    move differently by more than lr / 100 (measured 0.42 %)."""
    ref, layers, _, _ = runs
    r0 = layers[0]
    for res in layers:
        assert int(res["train/skipped"]) == 0
        assert float(res["train/loss"]) == float(r0["train/loss"])
        assert float(res["train/grad_norm"]) == float(r0["train/grad_norm"])
    assert abs(float(r0["train/loss"]) - float(r0["train1/loss"])) < 1e-3
    assert abs(float(r0["train1/loss"]) - float(ref["model/capacity/loss"])) < 1e-5
    gn, gn1 = float(r0["train/grad_norm"]), float(r0["train1/grad_norm"])
    assert abs(gn - gn1) <= GRAD_REL * gn1, (gn, gn1)
    assert gn1 > 1.0  # so the clip scaled this step's update
    lr = 1e-3 / 100  # OptimizerConfig(lr=1e-3) at step 1 of its 100-step warmup
    for k in [k for k in r0 if k.startswith("train/m/")]:
        gap, want = np.abs(r0[k] - r0["train1" + k[5:]]), np.abs(r0["train1" + k[5:]])
        assert gap.max() <= GRAD_REL * want.max(), (k, gap.max(), want.max())
    for k in [k for k in r0 if k.startswith("train/params/")]:
        gap = np.abs(r0[k] - r0["train1" + k[5:]])
        assert gap.max() <= 2 * lr, (k, gap.max())
        assert (gap > lr / 100).mean() <= 0.01, (k, (gap > lr / 100).mean())
        for res in layers[1:]:
            assert np.array_equal(res[k], r0[k]), k


def test_shard_then_gather_is_identity(runs):
    assert all(bool(res["roundtrip_ok"]) for res in runs[1])


@pytest.mark.parametrize("mode", MODES)
def test_paged_serving_over_mesh_1_4_matches_world_1(runs, mode):
    _, _, serve, _ = runs
    want = serve[0][f"serve1/{mode}/tokens"]
    assert want.shape == (4, 6)
    for res in serve:
        assert np.array_equal(res[f"serve/{mode}/tokens"], want)


def test_launchers_over_ranks(runs):
    """``launch.train --mesh 2,4`` prints the [mesh] line and feeds the
    drift report's a2a row from ``a2a.layer`` spans; every rank reports the
    same reduced loss.  ``launch.serve --mesh 1,4`` finishes its requests."""
    _, layers, serve, out = runs
    assert "[mesh] devices=8 ep=4 tp=1" in out and "[mesh] devices=4 ep=4 tp=1" in out
    assert "[trainer] ep a2a: flat x2 chunks (--a2a)" in out
    assert all(int(res["launch/ep"]) == 4 for res in layers)
    assert len({float(res["launch/loss"]) for res in layers}) == 1
    assert np.isfinite(float(layers[0]["launch/loss"]))
    assert int(layers[0]["launch/a2a_n"]) > 0
    assert all(res["launch/finished"].tolist() == [4, 4, 4] for res in serve)


def test_a2a_microbenchmarks_execute(runs):
    for res in runs[1]:
        assert res["bench/ranks"].tolist() == [4, 4]
        assert np.all(np.isfinite(res["bench/gbps"])) and np.all(res["bench/gbps"] > 0)
        assert np.all(res["bench/seconds"] > 0) and int(res["bench/spans"]) == 4


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------


def test_mesh_and_halo_helpers_equal_the_reference():
    for E in (1, 8, 40, 64):
        for m in range(1, 17):
            assert sharding.choose_ep(E, m) == jchoose_ep(E, m)
    for ep in range(1, 17):
        assert halo._pick_inner(ep) == jhalo._pick_inner(ep)
        for g1 in range(1, ep + 1):
            if ep % g1 == 0:
                assert halo.lane_groups(ep, g1) == jhalo.lane_groups(ep, g1)
                assert halo.node_groups(ep, g1) == jhalo.node_groups(ep, g1)
    for total in range(0, 40):
        for k in range(1, 9):
            assert halo.chunk_slices(total, k) == jhalo.chunk_slices(total, k)


class _FakePlan:
    def __init__(self, ep, ep_rank):
        self.ep, self.ep_rank = ep, ep_rank


def test_shard_params_takes_each_ranks_expert_slots():
    arch = get_arch("granite-moe-3b-a800m").reduced()
    params = init_params(arch, torch.Generator().manual_seed(0), "cpu")
    assert shard_params(params, None) is params
    shards = [shard_params(params, _FakePlan(4, g)) for g in range(4)]
    ffn = params["blocks"][0]["ffn"]
    for k in ("w_up", "w_gate", "w_down"):
        parts = [s["blocks"][0]["ffn"][k] for s in shards]
        assert all(p.shape[1] == 2 for p in parts)
        assert torch.equal(torch.cat(parts, dim=1), ffn[k])
    for k in ("w_router", "assignment"):
        assert all(s["blocks"][0]["ffn"][k] is ffn[k] for s in shards)
    assert shards[1]["embed"] is params["embed"]


@pytest.mark.parametrize("mode", MODES)
def test_moe_ffn_at_ep_1_is_moe_ffn_local(mode):
    arch = get_arch("granite-moe-3b-a800m").reduced()
    arch = arch.replace(moe=dataclasses.replace(arch.moe, dispatch=mode))
    params = init_params(arch, torch.Generator().manual_seed(0), "cpu")
    ffn = {k: v[0] for k, v in params["blocks"][0]["ffn"].items()}
    x = torch.randn((2, 16, arch.d_model), generator=torch.Generator().manual_seed(1))
    want, wm = tmoe.moe_ffn_local(ffn, x, arch, train=True)
    for plan in (None, sharding.single_device_plan(arch)):
        for kw in ({}, {"token_sharded": False}, {"seq_shard": True}):
            got, gm = tmoe.moe_ffn(ffn, x, arch, plan, train=True, **kw)
            assert torch.equal(got, want)
            assert all(torch.equal(gm[k], wm[k]) for k in wm)


def _args(argv):
    return train_launch.parse_args(["--reduced", "--device", "cpu"] + argv)


@pytest.mark.parametrize("argv,world,match", [
    (["--mesh", "1,3"], 3, None),
    (["--mesh", "2,2", "--backend", "nccl"], 4, "NCCL will not put two ranks"),
    (["--mesh", "1,4"], 2, "needs 4 ranks"),
    (["--mesh", "1,4", "--pipeline"], 4, "pod axis"),
], ids=["tp", "nccl-one-card", "world", "pod"])
def test_launch_refusals(argv, world, match):
    """The refusals that stand; ``--mesh 1,3`` on the reduced 8 experts
    (ep 1, tp 3), once refused, is taken."""
    if match is None:
        assert ranks.check(_args(argv), world, cards=0) == "gloo"
        return
    with pytest.raises(SystemExit, match=match):
        ranks.check(_args(argv), world, cards=0)


def test_launchers_refuse_ckpt_dir_and_serving_data_parallelism(runs, monkeypatch, tmp_path):
    """``--ckpt-dir`` at world > 1 is accepted: the launcher at ``--mesh 2,4``
    (the module's run) saved one global checkpoint, at steps 2 and 3, which
    a world-1 run resumes at step 3 and trains on.  Serving data
    parallelism is accepted too: ``launch.serve --mesh 2,1`` passes the
    launcher's checks and asks for its two ranks' process group."""
    ck = Path(runs[1][0]["launch/ckpt"].item())
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000002", "step_00000003"]
    manifest = json.loads((ck / "step_00000003" / "manifest.json").read_text())
    assert manifest["shapes"]["params/blocks/0/ffn/w_up"][1] == 8  # every expert
    assert "load_stats" in manifest["extras"]
    s = train_launch.main(LAUNCH_ARGS + ["--steps", "4", "--ckpt-dir", str(ck)])
    assert s["resumed_from"] == 3 and s["world"] == 1 and np.isfinite(s["loss"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="mesh 2,1 needs 2 ranks, have no process group"):
        serve_launch.main(["--reduced", "--device", "cpu", "--mesh", "2,1"])


@pytest.mark.parametrize("ep", [5, 10, 20, 40])
def test_serving_refuses_an_ep_the_prefill_buckets_cannot_split(monkeypatch, ep):
    """granite's 40 experts allow ep 5, 10, 20 and 40, which do not divide
    the engine's prefill buckets (powers of two from 8): the serve launcher
    refuses them before any process group or weight exists, and the engine
    refuses such a plan before it serves; ep 1, 2, 4 and 8 pass."""
    monkeypatch.setenv("WORLD_SIZE", str(ep))
    with pytest.raises(SystemExit, match=f"ep={ep} does not divide the prefill buckets"):
        serve_launch.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu",
                           "--mesh", f"1,{ep}"])
    with pytest.raises(ValueError, match=f"ep={ep} does not divide"):
        Engine(SimpleNamespace(plan=_FakePlan(ep, 0)), {}, ServeConfig())
    for ok in (1, 2, 4, 8):
        check_ep(ok)
