#!/usr/bin/env python3
"""Where the JAX package's hot-expert replication departs from its
sentinel-table oracle, with the bf16 all-to-all wire on and off.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python scripts/replication_wire_diag.py [--wire-off]

The body of ``tests/_multidevice_child.py:check_replication`` on the CPU's
8 fake host devices: reduced granite-moe-3b-a800m, mesh (2, 4),
``max_replicas=2``, the live table ``[0, 3]`` against the sentinel table,
both dispatch modes.  Prints the loss of each, the decode output's largest
gap, and the three gradient leaves with the largest absolute gap (with the
leaf's largest magnitude and the relative norm gap).  ``--wire-off`` drops
the bf16 casts of the dispatch/combine payload (``_transport_bf16``) and
of the replica rows (``_replica_ffn``'s ``wire_bf16``) in this process
only; ``src/repro`` is not changed.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch
from repro.models import moe as moe_lib
from repro.models.model import LanguageModel, init_params
from repro.sharding import host_mesh, make_plan


def wire_off() -> None:
    moe_lib._transport_bf16 = lambda a2a_fn, x: a2a_fn(x)
    replica_ffn = moe_lib._replica_ffn

    def no_cast(*args, **kwargs):
        kwargs["wire_bf16"] = False
        return replica_ffn(*args, **kwargs)

    moe_lib._replica_ffn = no_cast


def with_live_table(params):
    blocks = []
    for blk in params["blocks"]:
        f = dict(blk["ffn"])
        f["replicas"] = jnp.tile(jnp.asarray([0, 3], jnp.int32), (f["replicas"].shape[0], 1))
        blocks.append({**blk, "ffn": f})
    return {**params, "blocks": tuple(blocks)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wire-off", action="store_true")
    args = ap.parse_args()
    if args.wire_off:
        wire_off()
    base = get_arch("granite-moe-3b-a800m").reduced()
    mesh = host_mesh((2, 4), ("data", "model"))
    toks = jax.random.randint(jax.random.PRNGKey(3), (8, 32), 0, base.vocab_size)
    batch = {"tokens": toks, "labels": toks}
    for mode in ("ragged", "capacity"):
        arch = base.replace(moe=dataclasses.replace(
            base.moe, dispatch=mode, capacity_factor=8.0, max_replicas=2))
        params = init_params(arch, jax.random.PRNGKey(0))
        plan = make_plan(mesh, arch)
        lm = LanguageModel(arch, plan)

        def loss_grads(p):
            with plan.mesh:
                loss, _ = jax.jit(lm.loss)(p, batch)
                g = jax.jit(jax.grad(lambda q: lm.loss(q, batch)[0], allow_int=True))(p)
            return float(loss), jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, g))[0]

        l0, g0 = loss_grads(params)
        l1, g1 = loss_grads(with_live_table(params))
        rows = []
        for (path, a), (_, b) in zip(g0, g1):
            if np.issubdtype(a.dtype, np.floating):
                d = np.abs(a.astype(np.float64) - b.astype(np.float64))
                rows.append((float(d.max()), jax.tree_util.keystr(path),
                             float(np.abs(a).max()),
                             float(np.linalg.norm(a - b) / np.linalg.norm(a))))
        rows.sort(reverse=True)
        ffn = jax.tree.map(lambda t: t[0], params["blocks"][0]["ffn"])
        x = jax.random.normal(jax.random.PRNGKey(1), (8, 16, arch.d_model))
        with plan.mesh:
            decode = jax.jit(lambda f, xx: moe_lib.moe_ffn(f, xx, arch, plan,
                                                           token_sharded=False))
            y0, _ = decode(ffn, x)
            y1, _ = decode(dict(ffn, replicas=jnp.asarray([0, 3], jnp.int32)), x)
        dy = float(np.abs(np.asarray(y0) - np.asarray(y1)).max())
        print(f"wire {'off' if args.wire_off else 'on'}, {mode}: loss sentinel {l0!r} live "
              f"{l1!r} (bitwise {l0 == l1}); decode max |dy| {dy:.3e}")
        for gap, name, scale, rel in rows[:3]:
            print(f"    grad {name}: max |d| {gap:.3e}, max |g| {scale:.4g}, "
                  f"relative norm gap {rel:.3e}")


if __name__ == "__main__":
    main()
