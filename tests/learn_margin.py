#!/usr/bin/env python3
"""How far the training loss falls in 30 steps on one fixed batch: the JAX
package's training step on the CPU against the port's, from the same
initial weights, at the tiny training configuration of ``chip_smoke.py``
(its ``learn`` phase holds the port on the card to the JAX margin).

    JAX_PLATFORMS=cpu python tests/learn_margin.py [--steps 30] [--yaw]
        [--rbgnet] [--second]

``--yaw`` runs the SUN RGB-D configuration (the yaw path) on headed
scenes, the setting of ``chip_smoke.py``'s SUN RGB-D learn phase.
``--rbgnet`` runs the RBGNet YAML of the dataset instead, at the tiny
widths of ``chip_smoke.TINY_RBG`` (its ``rbgnet-learn`` phases), for
``chip_smoke.RBG_LEARN_STEPS`` steps unless ``--steps`` says otherwise,
and measures the drop as ``rbgnet-learn`` does: ``chip_smoke.rbg_drop``
(1 - the median of the second half / the first value) of the loss's
ungated part (``chip_smoke.rbg_learn_loss``: the vote, objectness and
sampling terms), on each of the batches of ``chip_smoke.RBG_LEARN_SEEDS``
(one JSON line each with both curves and the whole losses, then, with
several batches, one with the means, which ``rbgnet-learn`` compares).
``--second`` runs the KITTI
SECOND YAML at ``chip_smoke.tiny_second_config(learn=True)`` on
``chip_smoke.second_learn_batch`` with the YAML's adam_onecycle, for
``chip_smoke.SECOND_LEARN_STEPS`` steps (its ``second-learn`` phase).
``--seeds 11,12`` picks the fixed batches (every learn phase uses seed
11).

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
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seeds of the fixed batches")
    ap.add_argument("--yaw", action="store_true",
                    help="the SUN RGB-D configuration on headed scenes")
    ap.add_argument("--rbgnet", action="store_true",
                    help="the dataset's RBGNet YAML at tiny widths")
    ap.add_argument("--second", action="store_true",
                    help="the KITTI SECOND YAML at tiny widths")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from cagroup3d_tpu.config import EasyDict as JEasyDict
    from cagroup3d_tpu.models import build_network as jbuild
    from cagroup3d_tpu.parallel.mesh import make_train_step as jstep
    from cagroup3d_tpu.training.optimization import build_optimizer as jopt
    from chip_smoke import (CFGS, KITTI_CFG, LEARN_STEPS, RBG_CFGS,
                            RBG_LEARN_SEEDS, RBG_LEARN_STEPS,
                            SECOND_LEARN_STEPS, TINY_TRAIN_SCENE, build_model,
                            rbg_drop, rbg_learn_loss, rbg_model,
                            second_learn_batch, synthetic_train_batch,
                            tiny_rbg_model, tiny_second_config,
                            tiny_train_config)
    from cagroup3d_tpu_torch.models import build_network, load_config
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import build_optimizer

    torch.set_num_threads(4)
    name = "sunrgbd" if args.yaw else "scannet"
    epochs = 0
    if args.second:
        cfg = load_config(KITTI_CFG)
        tc, names = tiny_second_config(cfg, learn=True), \
            list(cfg.CLASS_NAMES)
        name, epochs = "kitti_second", int(cfg.OPTIMIZATION.NUM_EPOCHS)
        steps = args.steps or SECOND_LEARN_STEPS
        drop = lambda c: 1.0 - c[-1] / c[0]      # noqa: E731
        seeds, curve = (11,), lambda tb: float(tb["loss_all"])  # noqa: E731
    elif args.rbgnet:
        cfg = load_config(RBG_CFGS[name])
        tc, names = tiny_rbg_model(cfg.MODEL), list(cfg.CLASS_NAMES)
        name = f"rbgnet_{name}"
        steps, drop = args.steps or RBG_LEARN_STEPS, rbg_drop
        seeds, curve = RBG_LEARN_SEEDS, rbg_learn_loss
    else:
        tc, names, cfg = tiny_train_config(CFGS[name])
        steps = args.steps or LEARN_STEPS
        drop = lambda c: 1.0 - c[-1] / c[0]      # noqa: E731
        seeds, curve = (11,), lambda tb: float(tb["loss_all"])  # noqa: E731
    if args.seeds:
        seeds = tuple(map(int, args.seeds.split(",")))
    jm = jbuild(JEasyDict(dict(tc)), num_class=len(names))
    tx, _ = jopt(JEasyDict(dict(cfg.OPTIMIZATION)), STEPS_PER_EPOCH,
                 total_epochs=epochs)
    step = jstep(jm, tx, donate=False)
    drops = []
    for seed in seeds:
        if args.second:
            pm = build_network(tc, len(names), torch.Generator().manual_seed(
                1), device="cpu")
            batch = {k: torch.from_numpy(v)
                     for k, v in second_learn_batch(seed).items()}
        else:
            pm = rbg_model(tc, len(names), "cpu", seed=1) if args.rbgnet \
                else build_model(tc, len(names), "cpu", seed=1, train=True)
            batch = synthetic_train_batch(seed, "cpu", 2,
                                          n_classes=len(names),
                                          yaw=args.yaw, **TINY_TRAIN_SCENE)
        P = {k: jnp.asarray(v.detach().numpy())
             for k, v in pm.named_parameters()}
        S = {k: jnp.asarray(v.numpy()) for k, v in pm.named_buffers()}
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        opt_state = tx.init(P)
        rng = jax.random.PRNGKey(0)
        jl, jc = [], []
        for _ in range(steps):
            rng, sub = jax.random.split(rng)
            P, S, opt_state, loss, tb = step(P, S, opt_state, jb, sub,
                                             jnp.float32(0.0))
            jl.append(float(loss))
            jc.append(curve(tb))

        opt, _ = build_optimizer(pm, cfg.OPTIMIZATION, STEPS_PER_EPOCH,
                                 total_epochs=epochs)
        pstep = make_train_step(pm, opt, torch.Generator().manual_seed(0),
                                device="cpu")
        runs = [pstep(batch, 0.0) for _ in range(steps)]
        pl = [float(loss) for loss, _ in runs]
        pc = [curve(tb) for _, tb in runs]
        drops.append((drop(jc), drop(pc)))
        print(json.dumps({"config": name, "seed": seed, "steps": steps,
                          "jax_losses": jl, "port_cpu_losses": pl,
                          "jax_curve": jc, "port_cpu_curve": pc,
                          "jax_drop": drops[-1][0],
                          "port_cpu_drop": drops[-1][1]}), flush=True)
    if len(seeds) > 1:
        print(json.dumps({"config": name, "seeds": list(seeds),
                          "steps": steps,
                          "jax_mean_drop": sum(d[0] for d in drops) / len(
                              drops),
                          "port_cpu_mean_drop": sum(d[1] for d in drops) /
                          len(drops)}))


if __name__ == "__main__":
    main()
