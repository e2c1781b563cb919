"""The port's mesh in one process against the JAX package's on the
virtual 8-device CPU backend (``tests/conftest.py``): the sharded
``ClipEngine`` over 8 virtual CPU shards against JAX's on
``build_mesh()``; ``DeviceLibraryIndex`` and ``LibrarySearch`` with their
rows over 3 and 4 data shards (3: capacity rounded up to a multiple, as
JAX's ``library_index.py:317-321``) against JAX's sharded index and the
port's one-shard index, in every tier; ``param_spec`` and
``shard_params`` against JAX's specs on every leaf of the tiny CLIP; and
the kernel wrappers' device guard.

Ties: the CPU's plain scoring (a BLAS product) rounds a row's sum by
where the row sits in the table it scores, so two equal rows in two
shards can score one ulp apart there. The tie rows below are dyadic
(eighths, as is the tie query), so every partial sum is exact and the
ties are exact in every package and layout: their order is the merge's
alone. On the card the kernels score a row by its D alone
(``tests/test_torch_gpu.py`` holds the sharded index bit-equal to one
shard there).
"""

import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from avede_tpu.parallel.mesh import build_mesh as jbuild
from avede_tpu.services import library_index as jli
from avede_tpu_torch.models.convert import params_from_jax
from avede_tpu_torch.parallel.mesh import build_mesh
from avede_tpu_torch.services import library_index as tli

DTYPES = ["float32", "bfloat16", "int8"]
EMBED_TOL = 1e-5
CONF_TOL = 1e-6
DIM = 32


def _cpu_mesh(n, shape=None):
    return build_mesh([torch.device("cpu")] * n, shape=shape)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    from avede_tpu.models.clip import init_clip
    from avede_tpu.models.clip import tiny_test_config as jtiny
    from avede_tpu.parallel.embed import ClipEngine as JEngine
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine

    _, params = init_clip(jtiny(), seed=0)
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    return {"jax": JEngine(cfg=jtiny(), params=params, mesh=jbuild()),
            "sharded": ClipEngine(cfg=tiny_test_config(), state_dict=sd,
                                  mesh=_cpu_mesh(8)),
            "one": ClipEngine(cfg=tiny_test_config(), state_dict=sd,
                              device="cpu")}


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 255, size=(37, 40, 56, 3),
                                             dtype=np.uint8)


def test_engine_replicates_once_a_distinct_device(engines):
    eng = engines["sharded"]
    assert eng.mesh.n_data == 8 and len(eng._replicas) == 1
    assert eng.device == torch.device("cpu")


def test_sharded_embed_frames_matches_jax(engines, frames):
    got = engines["sharded"].embed_frames(frames)
    ref = engines["jax"].embed_frames(frames)
    one = engines["one"].embed_frames(frames)
    assert got.shape == ref.shape == (37, 32)
    assert float(np.abs(got - ref).max()) <= EMBED_TOL
    assert float(np.abs(got - one).max()) <= EMBED_TOL


def test_sharded_embed_stream_matches_jax(engines, frames):
    from avede_tpu.ops.dedup import rebatch as jrebatch
    from avede_tpu_torch.ops.dedup import rebatch

    chunks = [frames[:5], frames[5:19], frames[19:]]
    got = engines["sharded"].embed_stream(rebatch(iter(chunks), 12))
    ref = engines["jax"].embed_stream(jrebatch(iter(chunks), 12))
    assert got.shape == ref.shape == (37, 32)
    assert float(np.abs(got - ref).max()) <= EMBED_TOL


def test_sharded_pixels_and_device_table(engines, frames):
    rng = np.random.default_rng(1)
    px = rng.normal(size=(5, 32, 32, 3)).astype(np.float32)
    got = engines["sharded"].embed_pixels(px)
    np.testing.assert_allclose(got, engines["one"].embed_pixels(px),
                               atol=EMBED_TOL)
    emb, valid = engines["sharded"].embed_frames_device(frames[:10])
    assert emb.shape == (32, 32) and int(valid.sum()) == 10   # bucket 32 / 8


def test_sharded_query_window_topk_matches_jax(engines, frames):
    emb = engines["jax"].embed_frames(frames)
    mids = np.arange(2, len(frames) - 2, 2, dtype=np.int32)
    v_s, i_s = engines["sharded"].query_window_topk("a moving object", emb,
                                                    mids, 5)
    v_j, i_j = engines["jax"].query_window_topk("a moving object", emb,
                                                mids, 5)
    np.testing.assert_array_equal(np.asarray(i_s), np.asarray(i_j))
    assert float(np.abs(np.asarray(v_s) - np.asarray(v_j)).max()) \
        <= EMBED_TOL


def test_mesh_and_device_exclude_each_other():
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine

    with pytest.raises(ValueError, match="mesh or device"):
        ClipEngine(cfg=tiny_test_config(), device="cpu", mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="mesh or device"):
        tli.DeviceLibraryIndex(DIM, device="cpu", mesh=_cpu_mesh(2))


@pytest.mark.parametrize("axes", [None, ["model", "data"], ["batch", "model"],
                                  '["data", "model"]'],
                         ids=["default", "swapped", "renamed", "env_json"])
def test_mesh_axes_are_data_and_model(axes, monkeypatch):
    """``MESH_AXES`` keeps JAX's default; the port's mesh knows only those
    two names, so another value raises instead of being ignored."""
    from avede_tpu.utils.config import settings as jsettings
    from avede_tpu_torch.utils.config import settings
    from avede_tpu_torch.utils.errors import ConfigurationError

    assert settings.MESH_AXES == list(jsettings.MESH_AXES)
    if axes is not None:
        monkeypatch.setattr(settings, "MESH_AXES", axes)
    if axes in (None, '["data", "model"]'):
        assert _cpu_mesh(2).n_data == 2
        return
    with pytest.raises(ConfigurationError, match="MESH_AXES"):
        _cpu_mesh(2)


# ---------------------------------------------------------------------------
# the library index
# ---------------------------------------------------------------------------

def _unit(rng, n):
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _hits(hits):
    return [(h["video_id"], h["frame_index"], h["timestamp"]) for h in hits]


class _Trio:
    """JAX's sharded index, the port's sharded one and the port's
    one-shard one, fed the same calls."""

    def __init__(self, dtype, n):
        self.j = jli.DeviceLibraryIndex(DIM, dtype=dtype,
                                        mesh=jbuild(jax.devices()[:n]))
        self.t = tli.DeviceLibraryIndex(DIM, dtype=dtype, mesh=_cpu_mesh(n))
        self.one = tli.DeviceLibraryIndex(DIM, dtype=dtype, device="cpu")

    def add(self, vid, emb):
        for x in (self.j, self.t, self.one):
            x.add(vid, emb, np.arange(len(emb), dtype=np.float32) / 30.0)

    def remove(self, vid):
        for x in (self.j, self.t, self.one):
            x.remove(vid)

    def check(self, q, k, exact_ties=False):
        """The three searches' hits: identical where ``exact_ties`` (a
        dyadic query: every tie is exact), else identical but where two
        rows score within ``CONF_TOL`` (the duplicated rows under a
        random query score within an ulp of each other, as the CPU's
        product rounds them by position); confidences position by
        position within ``CONF_TOL``."""
        got, ref, one = (x.search(q, k) for x in (self.t, self.j, self.one))
        for other in (ref, one):
            assert len(got) == len(other)
            for i, (a, b) in enumerate(zip(got, other)):
                assert abs(a["confidence"] - b["confidence"]) <= CONF_TOL
                # a different row here must be a near tie (the check
                # above: the two rows score within CONF_TOL)
                assert not exact_ties or _hits([a]) == _hits([b]), (i, a, b)
        return got


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_index_matches_jax_and_one_shard(dtype, n, monkeypatch):
    monkeypatch.setattr(tli.settings, "LIBRARY_INDEX_DEDUP", False)
    from avede_tpu.utils.config import settings as jsettings

    monkeypatch.setattr(jsettings, "LIBRARY_INDEX_DEDUP", False)
    rng = np.random.default_rng(7 + n)
    tie = (rng.integers(-4, 5, size=(3, DIM)) / 8).astype(np.float32)
    q_tie = tie[0]                        # the tie rows score highest
    trio = _Trio(dtype, n)
    per_shard = []
    for i in range(12):
        emb = _unit(rng, int(rng.integers(90, 400)))
        emb[:3] = tie                     # equal rows in every span ...
        emb[-3:] = tie[::-1]              # ... at both of its ends
        trio.add(f"v{i:02d}", emb)
        if i == 3:
            trio.add("v01", _unit(rng, 300))          # replace
        if i == 6:
            trio.remove("v02")                        # a hole
        rows = trio.t._shards[0].table.shape[0]
        starts = [s for s in trio.t._starts]
        ends = [s + tli._padded(sp[2]) for s, sp in
                zip(trio.t._starts, trio.t._spans)]
        per_shard.append(any(s // rows != (e - 1) // rows
                             for s, e in zip(starts, ends)))
    # capacity as JAX rounds it; growth happened; a span crossed a shard
    assert trio.t.capacity == trio.j.capacity \
        and trio.t.capacity % n == 0 and trio.one.capacity <= trio.t.capacity
    assert trio.t.capacity > tli._MIN_CAPACITY and any(per_shard)
    assert len(trio.t._shards) == n
    for k in (1, 5, 64, 200):
        trio.check(q_tie, k, exact_ties=True)
        for q in _unit(rng, 2):
            trio.check(q, k)
    # the tie query's top: its row twice in each video but the replaced
    # one (a span's both ends), all equal, in the one-device order (by
    # row) across every shard boundary
    tied = 2 * (trio.t.n_videos - 1)
    top = trio.check(q_tie, tied, exact_ties=True)
    assert len(top) == tied and len({h["confidence"] for h in top}) == 1
    assert len({h["video_id"] for h in top}) == trio.t.n_videos - 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_tables_equal_jax(dtype):
    n = 3
    rng = np.random.default_rng(2)
    trio = _Trio(dtype, n)
    for i in range(6):
        trio.add(f"v{i}", _unit(rng, int(rng.integers(200, 500))))
    t, j = trio.t, trio.j
    np.testing.assert_array_equal(t._valid.numpy(), np.asarray(j._valid))
    if dtype == "int8":
        np.testing.assert_array_equal(t._table.numpy(), np.asarray(j._table))
        np.testing.assert_array_equal(t._scales.numpy(),
                                      np.asarray(j._scales))
    else:
        np.testing.assert_array_equal(t._table.float().numpy(),
                                      np.asarray(j._table, np.float32))


@pytest.mark.parametrize("n", [3, 4])
def test_library_search_shards_over_the_engines_mesh(n, monkeypatch):
    """Both packages' ``LibrarySearch`` hand the engine's mesh to their
    index; the same videos give the same hits."""
    from avede_tpu.services.library_search import LibrarySearch as JSearch
    from avede_tpu_torch.services.library_search import LibrarySearch

    rng = np.random.default_rng(11)
    tables = {f"v{i}": _unit(rng, int(rng.integers(100, 500)))
              for i in range(8)}
    q = _unit(rng, 1)

    def phase1(mesh):
        engine = SimpleNamespace(cfg=SimpleNamespace(projection_dim=DIM),
                                 mesh=mesh, embed_texts=lambda _: q)
        return SimpleNamespace(engine=engine, frame_embeddings=lambda p, v: (
            tables[v], np.arange(len(tables[v]), dtype=np.float32)))

    out = []
    for cls, mesh in ((JSearch, jbuild(jax.devices()[:n])),
                      (LibrarySearch, _cpu_mesh(n))):
        search = cls(phase1(mesh))
        search.list_videos = lambda: sorted(tables)
        search._resolve = lambda vid: vid
        res = search._search_indexed("q", top_k=20, threshold=-1.0,
                                     per_video_k=4, t0=0.0)
        out.append([(r["video_id"], r["frame_index"], r["confidence"])
                    for r in res["results"]])
        if cls is LibrarySearch:
            assert search._index.mesh is mesh
            assert len(search._index._shards) == n
    (ref, got) = out
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    assert max(abs(a[2] - b[2]) for a, b in zip(got, ref)) <= CONF_TOL


def test_concurrent_adds_and_searches_on_shards():
    idx = tli.DeviceLibraryIndex(DIM, dtype="int8", mesh=_cpu_mesh(3))
    rng = np.random.default_rng(5)
    tabs = [_unit(rng, 300) for _ in range(6)]
    errors = []

    def writer(i):
        try:
            for r in range(4):
                idx.add(f"w{i}-{r}", tabs[(i + r) % 6], np.arange(300.0))
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for _ in range(20):
        for h in idx.search(tabs[0][0], 8):
            assert np.isfinite(h["confidence"])
    for t in threads:
        t.join()
    assert not errors and idx.n_videos == 12
    assert idx.search(tabs[0][0], 1)[0]["confidence"] > 0.99


# ---------------------------------------------------------------------------
# tensor-parallel specs
# ---------------------------------------------------------------------------

def test_param_spec_matches_jax_on_every_leaf():
    """The port's spec of each parameter against JAX's of its leaf (a
    ``Linear`` weight is the kernel transposed, so its spec reversed)."""
    from avede_tpu.models.clip import init_clip
    from avede_tpu.models.clip import tiny_test_config as jtiny
    from avede_tpu.parallel.train import param_spec as jspec
    from avede_tpu_torch.models import convert
    from avede_tpu_torch.models.clip import init_clip as tinit
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.train import param_shardings, param_spec

    _, params = init_clip(jtiny(), seed=0)
    specs = jax.tree_util.tree_map_with_path(jspec, params)
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    model = tinit(tiny_test_config())
    names = dict(model.named_parameters())
    shardings = param_shardings(model, _cpu_mesh(2, shape=[1, 2]))
    assert len(leaves) == len(names) == len(shardings)
    sharded = 0
    for path, spec in leaves:
        keys = [p.key for p in path]
        port, _ = convert._key_and_value("/".join(keys), np.zeros(()))
        got = param_spec(port, names[port])
        assert (tuple(reversed(got)) if keys[-1] == "kernel" else got) \
            == tuple(spec), keys
        assert shardings[port] == got
        sharded += bool(got)
    # a block: q, k, v and fc1 weights and biases, out_proj and fc2
    # weights; two vision and two text blocks
    assert sharded == 4 * 10


def test_shard_params_keeps_this_ranks_slices():
    """``shard_params`` on rank (0, 1) of a 1 × 2 process mesh: each
    sharded parameter is the second half of its sharded dim."""
    from avede_tpu_torch.models.clip import init_clip, tiny_test_config
    from avede_tpu_torch.models.layers import MLP, MultiHeadAttention
    from avede_tpu_torch.parallel.mesh import MeshContext
    from avede_tpu_torch.parallel.train import param_spec, shard_params

    cpu = torch.device("cpu")
    mesh = MeshContext(((cpu, cpu),), rank=1, data_group="d",
                       model_group="m")
    whole = dict(init_clip(tiny_test_config()).named_parameters())
    model = shard_params(init_clip(tiny_test_config()), mesh)
    for name, p in model.named_parameters():
        spec = param_spec(name)
        if "model" not in spec:
            assert torch.equal(p, whole[name]), name
            continue
        dim = spec.index("model")
        assert p.shape[dim] * 2 == whole[name].shape[dim]
        assert torch.equal(p, whole[name].chunk(2, dim)[1]), name
    tp = [m.tp_group for m in model.modules()
          if isinstance(m, (MultiHeadAttention, MLP))]
    assert tp and set(tp) == {"m"}


def test_shard_params_refuses_heads_that_do_not_split():
    import dataclasses

    from avede_tpu_torch.models.clip import init_clip, tiny_test_config
    from avede_tpu_torch.parallel.mesh import MeshContext
    from avede_tpu_torch.parallel.train import shard_params

    cpu = torch.device("cpu")
    mesh = MeshContext(((cpu,) * 3,), rank=0, data_group="d",
                       model_group="m")
    with pytest.raises(ValueError, match="heads do not split"):
        shard_params(init_clip(tiny_test_config()), mesh)
    cfg = dataclasses.replace(tiny_test_config(), vision_heads=3,
                              text_heads=3, vision_dim=48, text_dim=48)
    mesh2 = MeshContext(((cpu,) * 2,), rank=0, data_group="d",
                        model_group="m")
    with pytest.raises(ValueError, match="heads do not split"):
        shard_params(init_clip(cfg), mesh2)


# ---------------------------------------------------------------------------
# the kernel wrappers' device guard
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _wrapper_calls():
    """Every kernel wrapper on meta tensors (shapes it takes on a card)."""
    from avede_tpu_torch.ops import attention, kernels, quant

    split = (_meta(64, 192, dtype=torch.bfloat16),
             _meta(64, 192, dtype=torch.bfloat16))
    w2, b2 = _meta(192, 64), _meta(64)
    emb, valid = _meta(256, 32), _meta(256, dtype=torch.bool)
    q = _meta(32)
    bf, i8, sc = (_meta(256, 32, dtype=torch.bfloat16),
                  _meta(256, 32, dtype=torch.int8), _meta(256))
    mids = _meta(10, dtype=torch.int32)
    qkv = _meta(2, 17, 4, 16, dtype=torch.bfloat16)
    x = _meta(256, 32)
    return {
        "fused_patch_embed": lambda: kernels.fused_patch_embed(
            _meta(2, 32, 32, 3, dtype=torch.uint8), w2, b2, 8, split),
        "fused_patch_embed_i420": lambda: kernels.fused_patch_embed_i420(
            _meta(2, 48, 32, dtype=torch.uint8), w2, b2, 8, split),
        "cosine_scores": lambda: kernels.cosine_scores(emb, q, valid),
        "cosine_scores_bf16": lambda: kernels.cosine_scores_bf16(bf, q,
                                                                 valid),
        "cosine_scores_int8": lambda: kernels.cosine_scores_int8(i8, sc, q,
                                                                 valid),
        "cosine_window_topk": lambda: kernels.cosine_window_topk(
            emb, valid, q, mids, 5),
        "cosine_topk_f32": lambda: kernels.cosine_topk_f32(emb, q, valid,
                                                           8),
        "cosine_topk_bf16": lambda: kernels.cosine_topk_bf16(bf, q, valid,
                                                             8),
        "cosine_topk_int8": lambda: kernels.cosine_topk_int8(i8, sc, q,
                                                             valid, 8),
        "flash_attention": lambda: attention.flash_attention(
            _meta(2, 4, 17, 16), _meta(2, 4, 17, 16), _meta(2, 4, 17, 16)),
        "flash_attention_blhd": lambda: attention.flash_attention_blhd(
            qkv, qkv, qkv),
        "quantize_per_channel": lambda: quant.quantize_per_channel(x),
        "quantize_rows": lambda: quant.quantize_rows(x),
        "quantize_rows_into": lambda: quant.quantize_rows_into(
            x, _meta(256, 32, dtype=torch.int8), _meta(256),
            _meta(256, dtype=torch.bool), 200),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_every_wrapper_launches_through_the_device_guard(name, monkeypatch):
    """Every kernel wrapper launches through ``_build.launch`` with its
    tensors' device (which it makes current: an entry launches on the
    current device and keeps its state by it). Meta tensors stand for a
    card's: the wrappers take their plain versions only on the CPU."""
    from avede_tpu_torch.ops import _build, attention, kernels, quant

    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda device, lib, symbol, argtypes, *args:
                        calls.append((device, lib, symbol, len(args),
                                      len(argtypes))))
    monkeypatch.setattr(_build, "entry", lambda *a: (lambda: 64))
    for mod in (kernels, attention, quant):
        monkeypatch.setattr(mod, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(attention, "_row_stride",
                        lambda q, k, v: q.shape[2] * q.shape[3])
    _wrapper_calls()[name]()
    assert len(calls) == 1, calls
    device, lib, symbol, n_args, n_types = calls[0]
    assert device == torch.device("meta") and n_args == n_types
    assert lib in _build.sources()


def test_launch_makes_the_device_current(monkeypatch):
    """``_build.launch`` calls the entry inside ``torch.cuda.device`` of
    the device it is given, with that device's current stream last."""
    from avede_tpu_torch.ops import _build

    seen = []

    class Guard:
        def __init__(self, device):
            seen.append(("enter", device))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            seen.append(("exit",))

    stream = SimpleNamespace(cuda_stream=1234)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: seen.append(("stream", device))
                        or stream)
    monkeypatch.setattr(_build, "entry", lambda lib, sym, types:
                        lambda *args: seen.append(("call", args)) or 0)
    dev = torch.device("cuda", 1)
    _build.launch(dev, "quantize", "avede_quantize_rows", [], 7, 8)
    assert seen == [("enter", dev), ("stream", dev), ("call", (7, 8, 1234)),
                    ("exit",)]
