#!/usr/bin/env python3
"""How far the training loss falls in 30 steps on one fixed batch: the JAX
package's training step on the CPU against the port's, from the same
initial weights, at the tiny training configuration of ``chip_smoke.py``
(its ``learn`` phase holds the port on the card to the JAX margin).

    JAX_PLATFORMS=cpu python tests/learn_margin.py [--steps 30] [--yaw]

``--yaw`` runs the SUN RGB-D configuration (the yaw path) on headed
scenes, the setting of ``chip_smoke.py``'s SUN RGB-D learn phase.

Prints one JSON line: both loss curves and their drops, 1 - last / first.
The random streams differ between the packages (``jax.random`` against
``torch.Generator``: capacity windows, RoI sampling, GT jitter), so the
curves agree in trend, not step by step.
"""
import argparse
import json
import os
import sys


HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

STEPS_PER_EPOCH = 1000      # no LR decay step inside the run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--yaw", action="store_true",
                    help="the SUN RGB-D configuration on headed scenes")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from cagroup3d_tpu.config import EasyDict as JEasyDict
    from cagroup3d_tpu.models import build_network as jbuild
    from cagroup3d_tpu.parallel.mesh import make_train_step as jstep
    from cagroup3d_tpu.training.optimization import build_optimizer as jopt
    from chip_smoke import (CFGS, TINY_TRAIN_SCENE, build_model,
                            synthetic_train_batch, tiny_train_config)
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import build_optimizer

    torch.set_num_threads(4)
    name = "sunrgbd" if args.yaw else "scannet"
    tc, names, cfg = tiny_train_config(CFGS[name])
    pm = build_model(tc, len(names), "cpu", seed=1, train=True)
    batch = synthetic_train_batch(11, "cpu", 2, n_classes=len(names),
                                  yaw=args.yaw, **TINY_TRAIN_SCENE)

    jm = jbuild(JEasyDict(dict(tc)), num_class=len(names))
    P = {k: jnp.asarray(v.detach().numpy()) for k, v in pm.named_parameters()}
    S = {k: jnp.asarray(v.numpy()) for k, v in pm.named_buffers()}
    tx, _ = jopt(JEasyDict(dict(cfg.OPTIMIZATION)), STEPS_PER_EPOCH)
    step = jstep(jm, tx, donate=False)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    opt_state = tx.init(P)
    rng = jax.random.PRNGKey(0)
    jl = []
    for _ in range(args.steps):
        rng, sub = jax.random.split(rng)
        P, S, opt_state, loss, _ = step(P, S, opt_state, jb, sub,
                                        jnp.float32(0.0))
        jl.append(float(loss))

    opt, _ = build_optimizer(pm, cfg.OPTIMIZATION, STEPS_PER_EPOCH)
    pstep = make_train_step(pm, opt, torch.Generator().manual_seed(0),
                            device="cpu")
    pl = [float(pstep(batch, 0.0)[0]) for _ in range(args.steps)]
    drop = lambda c: 1.0 - c[-1] / c[0]          # noqa: E731
    print(json.dumps({"config": name, "steps": args.steps,
                      "jax_losses": jl,
                      "port_cpu_losses": pl, "jax_drop": drop(jl),
                      "port_cpu_drop": drop(pl)}))


if __name__ == "__main__":
    main()
