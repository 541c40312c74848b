"""Training launcher, the twin of ``python -m repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        [--shape train_4k] [--steps 100] [--reduced] [--eigenpre] \
        [--batch 4] [--seq 64] [--microbatch 2] [--dtype float32|bfloat16] \
        [--ckpt-dir artifacts/ckpt] [--ckpt-every 50] [--resume] \
        [--seed 0] [--log-every 10] [--device cpu] [--mesh DxM]

Wires together: config registry -> model (weights drawn from ``--seed`` on
the device) -> ``TrainState`` in ``repro``'s stacked layout -> synthetic
data pipeline (prefetched) -> ``Supervisor`` (checkpoint/restart under
``--ckpt-dir/<arch>``, SIGTERM/SIGINT checkpoint then ``Preempted``,
straggler watchdog) -> training loop.  ``--reduced`` runs the smoke-size
config (a sequence of 64 and a batch of 4 unless ``--seq``/``--batch``
say otherwise); ``--eigenpre`` trains with ``EigenPre`` over AdamW, whose
refresh runs the EEI engine's kernels on the card.  It runs on the card
unless ``--device`` names another device; with no card and no
``--device`` it refuses to run.  Every config of the registry trains.
``--mesh DxM`` trains on a mesh of the first ``D*M`` cards, or with
``--device`` that device repeated (a logical mesh on one card, or the CPU):
the state is placed by ``repro``'s specs (FSDP when
``fsdp_recommended`` says so for the card's memory) and stepped by
``train.steps.build_programs``; the mesh and the bytes each of its
devices holds are logged.  ``--mesh PxDxM`` is refused (it waits for the
dry-run slice).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.data import PrefetchIterator, make_synthetic
from repro_torch.optim import AdamW, EigenPre
from repro_torch.runtime import StragglerWatchdog, Supervisor, SupervisorConfig
from repro_torch.train import TrainState, make_train_step, put_batch
from repro_torch.train.steps import build_programs

log = logging.getLogger("repro_torch.train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--shape", choices=sorted(SHAPES), default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: the first D*M cards, or with --device that "
                    "device repeated")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config")
    ap.add_argument("--batch", type=int, default=0,
                    help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--eigenpre", action="store_true",
                    help="EEI spectral preconditioner (the paper in the loop)")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import (
        POD_MESH_REFUSAL,
        log_mesh_bytes,
        mesh_axes,
        parse_mesh,
    )
    from repro_torch.models import LanguageModel
    from repro_torch.sharding.placement import put_tree

    if args.mesh.count("x") == 2:
        ap.error(POD_MESH_REFUSAL.format(args.mesh))
    try:
        data, model_axis = mesh_axes(args.mesh)
    except ValueError as exc:
        ap.error(f"--mesh: {exc}")
    mesh = (parse_mesh(args.mesh, args.device) if data * model_axis > 1
            else None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    logging.basicConfig(level=logging.INFO)

    shape = SHAPES[args.shape]
    if args.batch or args.seq:
        shape = dataclasses.replace(
            shape,
            global_batch=args.batch or shape.global_batch,
            seq_len=args.seq or shape.seq_len,
        )
    if args.reduced and not (args.batch and args.seq):
        shape = ShapeConfig(shape.name, args.seq or 64, args.batch or 4,
                            shape.kind)

    model = LanguageModel(cfg, device=mesh.first_device if mesh else
                          args.device)
    dev = model.device
    card = (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
            else "")
    optimizer = EigenPre() if args.eigenpre else AdamW()
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    log.info("arch=%s params=%.3fM on %s%s, %s, batch=%d seq=%d, %s",
             cfg.name, model.n_params() / 1e6, dev, card, args.dtype,
             shape.global_batch, shape.seq_len, type(optimizer).__name__)

    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    params = model.stacked_dict()
    state = TrainState(params, optimizer.init(params),
                       torch.zeros((), dtype=torch.int32))
    shardings = None
    if mesh is None:
        train_step = make_train_step(model, optimizer, compute_dtype,
                                     microbatch=args.microbatch or None)
    else:
        programs = build_programs(model, mesh, optimizer=optimizer,
                                  compute_dtype=compute_dtype,
                                  microbatch=args.microbatch or None)
        shardings = programs.state_shardings
        state = put_tree(state, shardings)
        del params
        model.release()
        train_step = programs.train_step
        log.info("%dx%d mesh, fsdp=%s", mesh.shape["data"],
                 mesh.shape["model"], programs.fsdp)
        log_mesh_bytes(log, mesh, state, "train state")

    manager = CheckpointManager(f"{args.ckpt_dir}/{cfg.name}", keep=3)
    supervisor = Supervisor(
        manager, SupervisorConfig(checkpoint_every=args.ckpt_every))
    supervisor.install_signal_handlers()
    start_step = 0
    if args.resume and manager.latest_step() is not None:
        state, extra = manager.restore(state, shardings=shardings)
        start_step = extra.get("data_step", manager.latest_step())
        log.info("resumed at step %s", start_step)

    source = make_synthetic(cfg, shape, seed=args.seed)
    data_iter = PrefetchIterator(source, start_step=start_step)
    watchdog = StragglerWatchdog()

    def step_fn(state, batch):
        return train_step(state, put_batch(batch, dev))

    t_start = time.monotonic()

    def on_metrics(step, metrics, dt):
        watchdog.observe(step, dt)
        if step % args.log_every == 0:
            log.info("step %5d loss %.4f |g| %.3f %.2fs/step", step,
                     float(metrics["loss"]),
                     float(metrics.get("grad_norm", 0.0)), dt)

    try:
        state = supervisor.run(state, data_iter, step_fn, args.steps,
                               state_shardings=shardings,
                               on_metrics=on_metrics)
    finally:
        data_iter.close()
    log.info("done: %d steps in %.1fs on %s%s (stragglers flagged: %d)",
             args.steps, time.monotonic() - t_start, dev, card,
             watchdog.events)
    return state


if __name__ == "__main__":
    main()
