"""The port's sequence-sharded serving layout against the JAX package's.

The reference serves its dense cache under its rule table: a prefill's
batch as ``("batch", "seq")`` (rows over the data axes, the sequence over
``("ep", "tp")``), a decode's as ``("batch", None)``, and each attention
cache as ``("layers", "batch", "kv_seq", None, None)`` with "kv_seq" =
(ep, tp) (``repro.training.batch_specs``, ``LanguageModel.cache_specs``),
an axis dropped where its size does not divide the dim.  The port's
``make_prefill_step`` gives each rank its block of the prompt,
``pad_cache`` moves the prefill's slices to each rank's "kv_seq" block,
and ``make_decode_step`` decodes each rank's rows against its block,
combining the softmax over the ranks' rows over the sequence group.
``_torch_mesh_child.py`` runs both sides side by side, from the port's
``init_params`` (seed 0): its ``serve-jax`` mode on 8 fake host devices
(three processes, each a part of the cases: the reference's jitted
``make_prefill_step`` / ``make_decode_step`` under those shardings, the
prefill's K/V padded to the cache's rows by hand as its callers do), its
``serve-port`` mode on 4 gloo ranks of the CPU, with world 1 on rank 0.
The EP layer's payload crosses in fp32 on both sides, so no bf16 rounding
of the wire flips a route.  Meanwhile this process traces a dry-run
decode cell on a fake 16-rank group.

* **The layout.** At (1, 4), (2, 2), (2, 1, 2) (the pod joining data) and
  a tp grid, every rank's prefill block, its rows of a decode batch (8
  rows, and 3, which no data grid splits), and the cache block
  ``pad_cache`` makes from its prefill slice (32 rows, and 18, which
  splits over 2 sequence ranks and not over 4) are exactly the blocks
  ``jax.device_put(..., NamedSharding(mesh, spec))`` puts on the same
  device; ``init_cache`` allocates blocks of those shapes.
* **Serving.** Reduced granite (both dispatch modes, cf 16) at (1, 4)
  and (2, 2): a 64-token prompt, then 8 decode steps into 128 rows; its
  capacity mode at cf 1.25 at (2, 2), where tokens drop by the tokens a
  rank holds (against the reference's plan; world 1 drops others);
  reduced gemma2 (window 32, both softcaps) at (1, 4), 40 steps, rank 0's
  rows outside the local window from the first; qwen2-vl (M-RoPE) on
  ``embeds`` at (1, 4); mamba2 and jamba (one rep) at (2, 2), 32
  positions a rank; mamba2 at (1, 4) on a 192-token prompt, 48 positions a
  rank (above the chunk of 32 and not a multiple of it).  Every rank returns the same logits; at every step
  they are within 1e-5 of the reference's and world 1's (gemma2: 1e-5 of
  the logits' magnitude), and each rank's cache block after the prefill
  and after the last step within 1e-5 of the reference's block on the
  same device (an SSM state within 1e-5 of max(1, its magnitude)); a
  decode index past an attention cache's rows raises on every rank,
  before any layer runs; a cache block mapped through ``map_tree`` decodes
  as the block itself, and one made a plain dict is refused.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch import sharding
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun

from _torch_mesh_child import (SEQ_LAYOUTS, SERVE_CACHE_ROWS, SERVE_CASES, SERVE_DECODE_ROWS,
                               SERVE_JAX_PARTS)

CHILD = Path(__file__).with_name("_torch_mesh_child.py")
SRC = Path(__file__).resolve().parents[1] / "src"
ATOL = 1e-5
WORLD = 4


def _child(args, env=None):
    return subprocess.Popen([sys.executable, str(CHILD)] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(SRC), **(env or {})})


def _wait(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:] + "\n" + err[-4000:]


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Both sides started at once (they share nothing but the seed)."""
    d = tmp_path_factory.mktemp("serve")
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"}
    procs = [_child(["serve-jax", str(d / f"ref{i}.npz"), str(i)], env)
             for i in range(len(SERVE_JAX_PARTS))]
    procs.append(_child(["serve-port", str(d)], {"OMP_NUM_THREADS": "1"}))
    yield d, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def runs(children):
    d, procs = children
    for p in procs:
        _wait(p)
    ref = {}
    for i in range(len(SERVE_JAX_PARTS)):
        ref.update(np.load(d / f"ref{i}.npz"))
    return ref, [dict(np.load(d / f"serve_rank{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# The dry run (in this process, while the children run)
# ---------------------------------------------------------------------------


def test_dry_run_decode_holds_a_sixteenth_of_the_cache(children):
    """Reduced granite's decode cell on a fake 16-rank group at (1, 16)
    (ep 8 x tp 2): a rank's attention cache is the whole cache's bytes
    over ep * tp, and its decode step all-gathers the softmax's max and
    sum and all-reduces its products with V (one each a layer)."""
    arch = get_arch("granite-moe-3b-a800m").reduced()
    whole = dryrun.trace_step(arch, "decode", None, 4, 128)
    with dryrun.fake_world(16):
        plan = sharding.make_plan(arch, (1, 16))
        got = dryrun.trace_step(arch, "decode", plan, 4, 128)
    assert (plan.ep, plan.tp) == (8, 2)
    assert got["memory"]["cache_bytes"] * 16 == whole["memory"]["cache_bytes"]
    assert got["collectives"]["counts"]["all-gather"] >= arch.num_layers
    assert got["collectives"]["counts"]["all-reduce"] >= arch.num_layers


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(SEQ_LAYOUTS))
def test_each_rank_takes_the_reference_serving_blocks(runs, tag):
    ref, res = runs
    pre = f"serve/layout/{tag}"
    keys = sorted({k.split("/")[4] for k in ref if k.startswith(f"{pre}/prefill/")})
    assert "tokens" in keys
    for rank, r in enumerate(res):
        for k in keys:
            np.testing.assert_array_equal(r[f"{pre}/prefill/{k}"],
                                          ref[f"{pre}/prefill/{k}/{rank}"],
                                          err_msg=f"prefill {k} rank {rank}")
        for rows in SERVE_DECODE_ROWS:
            np.testing.assert_array_equal(r[f"{pre}/decode/{rows}"],
                                          ref[f"{pre}/decode/{rows}/{rank}"],
                                          err_msg=f"decode {rows} rows, rank {rank}")
        for rows in SERVE_CACHE_ROWS:
            cpre = f"{pre}/cache/{rows}"
            positions = sorted({k.split("/")[0] for k in (
                key[len(cpre) + 1:] for key in ref if key.startswith(cpre + "/"))})
            assert positions
            for pos in positions:
                for kv in ("k", "v"):
                    want = ref[f"{cpre}/{pos}/{kv}/{rank}"]
                    np.testing.assert_array_equal(r[f"{cpre}/{pos}/{kv}"], want,
                                                  err_msg=f"{rows} rows {pos}/{kv} rank {rank}")
                split = want.shape[2] != rows
                assert r[f"{cpre}/{pos}/kv_block"].tolist() == [split, split]
                assert r[f"{cpre}/{pos}/init_shape"].tolist() == list(want.shape)


# ---------------------------------------------------------------------------
# Prefill and decode against the reference's jitted steps and world 1
# ---------------------------------------------------------------------------


def _caches(res, tag):
    return {k[len(tag) + 1:]: v for k, v in res.items() if k.startswith(tag + "/")}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_sharded_serving_matches_the_reference_and_world_1(runs, case):
    ref, res = runs
    steps = SERVE_CASES[case][7]
    tag = f"serve/{case}"
    scale = case.startswith("gemma2")
    drop = "/drop/" in case
    for i in range(steps + 1):
        got = res[0][f"{tag}/logits/{i}"]
        for r in res[1:]:
            np.testing.assert_array_equal(r[f"{tag}/logits/{i}"], got, err_msg=f"step {i}")
        want = ref[f"{tag}/logits/{i}"]
        assert got.shape == want.shape
        tol = ATOL * max(1.0, float(np.abs(want).max())) if scale else ATOL
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"{case} step {i} vs the reference")
        one = res[0][f"{tag}/world1/logits/{i}"]
        if drop:
            if i == 0:  # the prefill drops other tokens at world 1
                assert float(np.abs(got - one).max()) > ATOL
        else:
            np.testing.assert_allclose(got, one, rtol=0, atol=tol,
                                       err_msg=f"{case} step {i} vs world 1")
    if not case.startswith("mamba2"):  # an SSM state has no rows to run past
        assert all(bool(r[f"{tag}/past_end_raises"]) for r in res)
        for r in res:  # a block through map_tree decodes as the block itself
            np.testing.assert_array_equal(r[f"{tag}/mapped_logits"], r[f"{tag}/logits/1"])
            assert bool(r[f"{tag}/plain_block_raises"])
    for when in ("cache0", "cache1"):
        for rank, r in enumerate(res):
            got = _caches(r, f"{tag}/{when}")
            want = {k: ref[f"{tag}/{when}/{k}/{rank}"] for k in got}
            assert sorted(got) == sorted(
                k[len(tag) + len(when) + 2:].rsplit("/", 1)[0] for k in ref
                if k.startswith(f"{tag}/{when}/") and k.endswith(f"/{rank}"))
            for k, w in want.items():
                assert got[k].shape == w.shape, (when, k, rank)
                tol = ATOL * max(1.0, float(np.abs(w).max())) if k.endswith("/ssm") else ATOL
                np.testing.assert_allclose(got[k], w, rtol=0, atol=tol,
                                           err_msg=f"{case} {when} {k} rank {rank}")
