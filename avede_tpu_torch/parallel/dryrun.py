"""Multi-process check of the port's mesh: the twin of the JAX package's
``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:65-168``).

    python -m avede_tpu_torch.parallel.dryrun --n 4 --backend gloo
    torchrun --nproc-per-node N -m avede_tpu_torch.parallel.dryrun --backend nccl

``--backend nccl``, the default, runs one rank a card under ``torchrun``
(or, alone, a group of one) and raises without a card; ``--backend
gloo``, only when asked, spawns N processes on the CPU (not under
``torchrun``). The summary line names the backend and the devices.
:func:`dryrun_multichip` makes the JAX function's checks in its order:
one dp × tp CLIP step on the tiny config (tp = 2 when N is even) with a
finite loss; then, on rank 0, over a local mesh of the same shape (N
virtual shards of the CPU under gloo; the visible cards under NCCL, or
virtual shards of one card where there are fewer; a card serves the
tower in bf16, its bar 2e-3 where the CPU's f32 has JAX's 1e-4): the
sharded engine's embeddings equal to a one-device engine's, the sharded library index's
top-5 over three videos equal to a one-device index's, the fused
query's top-k, and ``embed_stream``.

:func:`run_ranks` runs a function on every rank of a gloo group of
spawned CPU processes (a file rendezvous, one thread a process, one
deadline for the whole run: a hung collective fails instead of
waiting); :func:`train_ranks` is its worker for step-by-step checks of
the trainers on a process mesh against one process.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import MeshContext, build_mesh, init_distributed

COLLECTIVE_TIMEOUT_S = 60.0


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, init_file: str, fn: Callable,
               args: tuple, results) -> None:
    torch.set_num_threads(1)
    try:
        init_distributed("gloo", f"file://{init_file}", world, rank,
                         timeout=COLLECTIVE_TIMEOUT_S)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              timeout: float = 120.0) -> List[Any]:
    """``fn(rank, *args)`` on each rank of a gloo group of ``world``
    spawned CPU processes → the ranks' results, in rank order (each must
    pickle). Raises on a rank's error, or when the run passes
    ``timeout`` seconds (every process is killed)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="avede-ranks-") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, init_file, fn, tuple(args),
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got: Dict[int, Any] = {}
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world - len(got)} of {world} ranks "
                                       f"did not finish in {timeout} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank exited with {dead[0]}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(5.0)
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# the trainers at their tiny configs
# ---------------------------------------------------------------------------

TRAINERS = ("clip", "grounding", "caption", "reid", "yolo")


def tiny_trainer(kind: str, mesh: Optional[MeshContext] = None,
                 device=None) -> Tuple[Any, Callable]:
    """``(state, step)`` of one of the port's trainers at its tiny config
    (seed 0), with the optimizer the tests and the eval modes give it:
    ``clip`` (the CLIP step, tensor-parallel over the mesh's model axis),
    ``grounding``, ``caption``, ``reid`` or ``yolo`` (data-parallel), on
    ``device`` or this rank's cell of a process ``mesh``."""
    from . import train
    from .optim import adamw

    if mesh is not None:
        device = mesh.device
    if kind == "clip":
        from ..models.clip import tiny_test_config

        model, state = train.create_train_state(
            tiny_test_config(), mesh=mesh, learning_rate=1e-3,
            device=None if mesh is not None else device)
        return state, train.make_train_step(model, mesh)
    if kind == "grounding":
        from ..models.univtg import tiny_grounding_config

        model, state = train.create_grounding_train_state(
            tiny_grounding_config(16), learning_rate=1e-3, device=device)
        return state, train.make_grounding_train_step(model, mesh)
    if kind == "caption":
        import dataclasses

        from ..models.blip import init_blip, tiny_blip_config

        cfg = dataclasses.replace(tiny_blip_config(), use_flash=False)
        model = init_blip(cfg, seed=0).to(device).train()
        state = train.TrainState(model, adamw(
            model.parameters(), 1e-3, weight_decay=1e-4, clip_norm=1.0))
        return state, train.make_caption_train_step(model, cfg.pad_token_id,
                                                    mesh)
    if kind == "reid":
        from ..models.appearance import tiny_appearance_config
        from .train_reid import create_reid_train_state, make_reid_train_step

        model, state = create_reid_train_state(
            tiny_appearance_config(), learning_rate=1e-3, device=device)
        return state, make_reid_train_step(model, mesh)
    if kind == "yolo":
        from ..models.yolo import YoloConfig
        from .train_det import create_yolo_train_state, make_yolo_train_step

        model, state = create_yolo_train_state(
            YoloConfig(num_classes=4, img_size=64), 2e-3, device=device)
        return state, make_yolo_train_step(model, mesh)
    raise ValueError(f"unknown trainer {kind!r} (one of {TRAINERS})")


def run_trainer(kind: str, batches: Sequence[Sequence[np.ndarray]],
                mesh: Optional[MeshContext] = None, device=None,
                restore: Optional[str] = None, save: Optional[str] = None
                ) -> Dict[str, Any]:
    """``len(batches)`` steps of :func:`tiny_trainer`'s ``kind`` on the
    given global batches (numpy), the state first restored from the
    checkpoint ``restore`` and at the end saved to ``save`` (each a
    directory of ``train.save_checkpoint``) → ``{"loss": [...],
    "grad_norm": [...], "params": whole parameters as numpy}``."""
    from . import train

    state, step = tiny_trainer(kind, mesh, device)
    dev = next(state.module.parameters()).device
    if restore is not None:
        train.restore_checkpoint(state, restore)
    losses, norms = [], []
    for batch in batches:
        state, metrics = step(state, *(torch.from_numpy(np.asarray(a)).to(dev)
                                       for a in batch))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    if save is not None:
        train.save_checkpoint(state, save, state.step)
    params = train.gather_state_dict(state)["params"]
    return {"loss": losses, "grad_norm": norms,
            "params": {k: v.detach().cpu().numpy() for k, v in params.items()}}


def train_ranks(rank: int, runs: Sequence[Dict[str, Any]],
                shape: Sequence[int]) -> Optional[List[Dict[str, Any]]]:
    """:func:`run_ranks` worker: each of ``runs`` (keyword arguments of
    :func:`run_trainer`) on the process mesh of ``shape`` → rank 0's
    results (the parameters are whole on every rank)."""
    mesh = build_mesh(shape=shape)
    out = [run_trainer(mesh=mesh, **run) for run in runs]
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _serving_devices(n: int) -> List[torch.device]:
    """Rank 0's devices for the local mesh: ``n`` virtual CPU shards
    under gloo; under NCCL the first ``n`` cards, or ``n`` virtual
    shards of this rank's card where fewer are visible."""
    if dist.get_backend() != "nccl":
        return [torch.device("cpu")] * n
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", torch.cuda.current_device())] * n


def dryrun_multichip(n_devices: Optional[int] = None) -> Optional[str]:
    """The checks of ``__graft_entry__.dryrun_multichip`` on the process
    group (every rank calls; initialize it first) → rank 0's summary
    line (None on the other ranks). Raises on a failed check."""
    from ..models.clip import tiny_test_config
    from ..ops.dedup import rebatch
    from ..services.library_index import DeviceLibraryIndex
    from ..utils.platform import with_compute_dtype
    from . import train
    from .embed import ClipEngine

    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"{n} devices asked, {dist.get_world_size()} ranks")
    # dp × tp: a model axis of 2 when the device count allows it
    model_par = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = build_mesh(shape=[n // model_par, model_par])

    cfg = tiny_test_config()
    model, state = train.create_train_state(cfg, mesh)
    step = train.make_train_step(model, mesh)
    batch = max(mesh.n_data * 2, 4)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(batch, cfg.image_size, cfg.image_size, 3)
                        ).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size - 2, size=(batch, cfg.max_text_len)
                       ).astype(np.int32)
    ids[:, -1] = cfg.vocab_size - 1
    dev = mesh.device
    state, metrics = step(state, torch.from_numpy(images).to(dev),
                          torch.from_numpy(ids).to(dev))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    params = {k: v.cpu() for k, v in
              train.gather_state_dict(state)["params"].items()}
    if dist.get_rank() != 0:
        return None

    # sharded INFERENCE: frames split over the data axis must embed as on
    # one device (a card serves in bf16, as the eval modes' tiny towers do)
    devices = _serving_devices(n)
    serve_cfg = with_compute_dtype(cfg, devices[0])
    tol = 1e-4 if serve_cfg.dtype == "float32" else 2e-3
    serving = build_mesh(devices, shape=[mesh.n_data, mesh.n_model])
    engine = ClipEngine(cfg=serve_cfg, state_dict=params, mesh=serving)
    frames = rng.integers(0, 255, size=(max(mesh.n_data * 3 + 1, 11),
                                        40, 56, 3), dtype=np.uint8)
    emb = engine.embed_frames(frames)
    single = ClipEngine(cfg=serve_cfg, state_dict=params,
                        mesh=build_mesh(devices[:1], shape=(1, 1)))
    emb_1 = single.embed_frames(frames)
    drift = float(np.abs(emb - emb_1).max())
    assert emb.shape == (len(frames), cfg.projection_dim)
    assert drift < tol, f"sharded embed drift {drift}"

    # sharded SERVING: the library index's rows over the data devices
    lib_sharded = DeviceLibraryIndex(cfg.projection_dim, dtype="float32",
                                     mesh=serving)
    lib_local = DeviceLibraryIndex(cfg.projection_dim, dtype="float32",
                                   device=devices[0])
    for i in range(3):
        tab = emb + 0.01 * i
        tab = tab / np.linalg.norm(tab, axis=-1, keepdims=True)
        lib_sharded.add(f"v{i}", tab, np.arange(float(len(tab))))
        lib_local.add(f"v{i}", tab, np.arange(float(len(tab))))
    q = np.asarray(emb[0], np.float32)
    hits_s = [(h["video_id"], h["frame_index"])
              for h in lib_sharded.search(q, 5)]
    hits_l = [(h["video_id"], h["frame_index"])
              for h in lib_local.search(q, 5)]
    assert hits_s == hits_l, "sharded library index diverged from one device"

    # the fused warm query must not depend on the shard count
    mids = np.arange(2, len(frames) - 2, 2, dtype=np.int32)
    k = min(5, len(mids))
    v_s, i_s = engine.query_window_topk("a bright moving object", emb,
                                        mids, k)
    v_1, i_1 = single.query_window_topk("a bright moving object", emb_1,
                                        mids, k)
    assert np.array_equal(i_s, i_1), "fused query top-k order diverged"
    qdrift = float(np.abs(v_s - v_1).max())
    assert qdrift < tol, f"fused query score drift {qdrift}"

    # STREAMING embed over the sharded mesh, as Phase1 runs it
    chunks = [frames[:5], frames[5:9], frames[9:]]
    emb_stream = engine.embed_stream(rebatch(iter(chunks), 6))
    sdrift = float(np.abs(emb_stream - emb_1).max())
    assert emb_stream.shape == emb_1.shape
    assert sdrift < tol, f"sharded embed_stream drift {sdrift}"

    serving_on = ", ".join(f"{d} ×{devices.count(d)}"
                           for d in dict.fromkeys(devices))
    return (f"dryrun_multichip: {n} devices (dp={mesh.n_data} × "
            f"tp={mesh.n_model}), backend {dist.get_backend()}, rank 0 "
            f"on {mesh.device}, serving on {serving_on}, "
            f"loss={loss:.4f}, sharded-embed "
            f"{emb.shape} max-drift {drift:.2e} vs 1-device, "
            f"sharded-library top-5 identical over {lib_sharded.n_rows} "
            f"rows, fused-query top-{k} identical (score drift "
            f"{qdrift:.2e}), embed_stream drift {sdrift:.2e}")


def _dryrun_rank(rank: int) -> Optional[str]:
    return dryrun_multichip()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="ranks (gloo: processes to spawn; nccl: the "
                         "torchrun world, default its WORLD_SIZE)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="nccl",
                    help="nccl (default): one card a rank, raises without "
                         "a card; gloo: N processes on the CPU, only when "
                         "asked")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for the whole gloo run")
    args = ap.parse_args(argv)
    if args.backend == "gloo":
        if "WORLD_SIZE" in os.environ:
            raise SystemExit("--backend gloo spawns its own CPU processes; "
                             "under torchrun pass --backend nccl")
        line = run_ranks(_dryrun_rank, args.n or 2, timeout=args.timeout)[0]
    else:
        alone = "WORLD_SIZE" not in os.environ
        with tempfile.TemporaryDirectory(prefix="avede-dryrun-") as tmp:
            if alone:
                if (args.n or 1) != 1:
                    raise SystemExit("--backend nccl with --n > 1 runs "
                                     "under torchrun")
                init_distributed("nccl", f"file://{tmp}/rendezvous", 1, 0)
            else:
                init_distributed("nccl")
            try:
                line = dryrun_multichip(args.n)
            finally:
                dist.destroy_process_group()
    if line is not None:
        print(line)
        print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
