"""The public names of ported modules that the port had lacked, each held
against its JAX counterpart on the same inputs: the embedding cache's
``invalidate`` / ``stats``, ``FrameRetention.retained_bytes``,
``ClipWriter.list_clips``, ``tokenizer.get_tokenizer``,
``dedup.frame_signature``, ``memory.chunked``, ``trace.profile_to``,
``parallel.embed.get_engine`` / ``set_engine``, ``errors.degrade`` with
its four error classes, ``CaptionService.rerank_scores`` and
``preprocess.fold_normalization``.
"""

import numpy as np
import pytest
import torch

from avede_tpu.io import clip_writer as jcw
from avede_tpu.io import embedding_cache as jec
from avede_tpu.io import frame_retention as jfr
from avede_tpu.models import tokenizer as jtok
from avede_tpu.ops import dedup as jdd
from avede_tpu.ops import preprocess as jpp
from avede_tpu.utils import errors as jerr
from avede_tpu.utils import memory as jmem
from avede_tpu.utils import trace as jtrace
from avede_tpu.utils.config import settings as jsettings
from avede_tpu_torch.io import clip_writer as tcw
from avede_tpu_torch.io import embedding_cache as tec
from avede_tpu_torch.io import frame_retention as tfr
from avede_tpu_torch.models import tokenizer as ttok
from avede_tpu_torch.ops import dedup as tdd
from avede_tpu_torch.ops import preprocess as tpp
from avede_tpu_torch.utils import errors as terr
from avede_tpu_torch.utils import memory as tmem
from avede_tpu_torch.utils import trace as ttrace
from avede_tpu_torch.utils.config import settings as tsettings


def _table(seed, n=12, d=16):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_embedding_cache_invalidate_and_stats(tmp_path):
    caches = {"jax": jec.EmbeddingCache(str(tmp_path / "j")),
              "port": tec.EmbeddingCache(str(tmp_path / "t"))}
    seen = {}
    for name, cache in caches.items():
        assert cache.stats() == {"entries": 0, "bytes": 0}
        for i, vid in enumerate(("a", "b", "c")):
            cache.put(vid, _table(i), [0.5 * t for t in range(12)], "tag",
                      (48, 64), 2)
        before = cache.stats()
        assert cache.get("b", "tag", 2) is not None
        cache.invalidate("b")
        cache.invalidate("missing")             # no entry: no error
        after = cache.stats()
        assert cache.get("b", "tag", 2) is None
        assert cache.get("a", "tag", 2) is not None
        files = sorted(p.name for p in cache.dir.glob("*.npz"))
        assert after["bytes"] == sum(
            (cache.dir / f).stat().st_size for f in files)
        seen[name] = (before["entries"], after["entries"], files)
    assert seen["jax"] == seen["port"] == (3, 2, ["a.npz", "c.npz"])


def test_frame_retention_retained_bytes(monkeypatch):
    for s in (jsettings, tsettings):
        monkeypatch.setattr(s, "FRAME_RETAIN_MB", 1)
    frames = np.zeros((4, 120, 160, 3), np.uint8)       # 230 KB a chunk
    ts = [0.0, 0.1, 0.2, 0.3]
    got = []
    for mod in (jfr, tfr):
        r = mod.FrameRetention()
        seq = [r.retained_bytes]
        r.begin("v")
        for i in range(6):                              # past the budget
            r.add("v", frames, [t + i for t in ts])
            seq.append(r.retained_bytes)
        r.release("v")
        seq.append(r.retained_bytes)
        r.begin("w")
        r.add("w", frames[:1], ts[:1])
        seq.append(r.retained_bytes)
        r.release("other")                              # not w's: no-op
        seq.append(r.retained_bytes)
        got.append(seq)
    assert got[0] == got[1]
    assert got[1][1] == frames.nbytes and got[1][-1] == frames[:1].nbytes
    assert 0 in got[1][2:7]


def test_clip_writer_list_clips(tmp_path):
    for name in ("b_1.mp4", "a_2.mp4", "notes.txt", "c.MP4.tmp"):
        (tmp_path / name).touch()
    assert tcw.ClipWriter(str(tmp_path)).list_clips() \
        == jcw.ClipWriter(str(tmp_path)).list_clips() \
        == ["a_2.mp4", "b_1.mp4"]


def test_get_tokenizer_is_one_default_tokenizer(monkeypatch):
    for mod in (jtok, ttok):
        monkeypatch.setattr(mod, "_DEFAULT", None)
    a, b = ttok.get_tokenizer(), ttok.get_tokenizer()
    assert a is b and isinstance(a, ttok.Tokenizer)
    texts = ["a red car turning left", "", "person walking a dog"]
    np.testing.assert_array_equal(a(texts), jtok.get_tokenizer()(texts))
    assert a.context_len == jtok.get_tokenizer().context_len


@pytest.mark.parametrize("shape", [(288, 512, 3), (33, 70, 3), (16, 16, 3),
                                   (720, 1280, 3)])
def test_frame_signature_matches_jax(shape):
    frame = np.random.default_rng(shape[0]).integers(
        0, 256, shape, dtype=np.uint8)
    got, ref = tdd.frame_signature(frame), jdd.frame_signature(frame)
    assert got.shape == ref.shape == (16, 16) and got.dtype == np.float32
    # the port's numpy INTER_AREA against cv2's (f32 sums in another
    # order; the signatures feed a 1/255-scale threshold)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("n,size", [(10, 3), (9, 3), (0, 4), (5, 0), (5, 9)])
def test_chunked_matches_jax(n, size):
    seq = list(range(n))
    assert list(tmem.chunked(seq, size)) == list(jmem.chunked(seq, size))
    arr = np.arange(n)
    for a, b in zip(tmem.chunked(arr, size), jmem.chunked(arr, size)):
        np.testing.assert_array_equal(a, b)


def test_profile_to_writes_a_trace_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("AVEDE_PROFILE", raising=False)
    for mod in (jtrace, ttrace):
        with mod.profile_to(None):                  # no directory: no-op
            pass
    with ttrace.profile_to(str(tmp_path / "port")):
        with ttrace.trace("leftover.span"):
            torch.ones(64).sum()
    with jtrace.profile_to(str(tmp_path / "jax")):
        pass
    for side in ("port", "jax"):
        files = [p for p in (tmp_path / side).rglob("*") if p.is_file()]
        assert files and all(p.stat().st_size > 0 for p in files), side
    port_trace = next((tmp_path / "port").rglob("*.json"))
    assert "leftover.span" in port_trace.read_text()
    # the environment variable names the directory when no argument does
    monkeypatch.setenv("AVEDE_PROFILE", str(tmp_path / "env"))
    with ttrace.profile_to():
        torch.zeros(8).add_(1)
    assert any((tmp_path / "env").rglob("*.json"))


def test_get_and_set_engine(monkeypatch):
    from avede_tpu.parallel import embed as jembed
    from avede_tpu_torch.parallel import embed as tembed
    from avede_tpu_torch.utils.errors import ConfigurationError

    for mod in (jembed, tembed):
        monkeypatch.setattr(mod, "_DEFAULT", None)
        marker = object()
        mod.set_engine(marker)
        assert mod.get_engine() is marker
        mod.set_engine(None)
    # the default engine is the card's, as every port entry point
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError):
        tembed.get_engine()
    assert tembed._DEFAULT is None


def test_error_classes_match_jax():
    for name in ("ModelLoadError", "InferenceError", "DetectionError",
                 "MatchingError"):
        j, t = getattr(jerr, name), getattr(terr, name)
        assert issubclass(t, terr.AvedeError) and t.code == j.code
        err = t("boom", frame=3)
        assert str(err) == "boom" and err.context == {"frame": 3}


def test_degrade_matches_jax(monkeypatch):
    results = []
    for mod in (jerr, terr):
        log = mod.ErrorLog()
        monkeypatch.setattr(mod, "error_log", log)

        @mod.degrade(default=list, component="detector")
        def detect(x):
            if x < 0:
                raise mod.DetectionError("negative")
            return [x]

        @mod.degrade(default=None, severity="warning",
                     exceptions=(KeyError,))
        def lookup(d, k):
            return d[k]

        a, b = detect(-1), detect(-2)
        out = (detect(2), a, a is b, lookup({"k": 1}, "k"),
               lookup({}, "x"), detect.__name__)
        with pytest.raises(ZeroDivisionError):      # not in exceptions
            _divide(mod)
        stats = log.stats()
        results.append((out, stats["total"], stats["by_code"],
                        [e["component"] for e in stats["recent"]],
                        [e["severity"] for e in stats["recent"]]))
    assert results[0] == results[1]
    assert results[1][0] == ([2], [], False, 1, None, "detect")
    assert results[1][2] == {"DETECTION": 2, "KeyError": 1}


def _divide(mod):
    @mod.degrade(default=0, exceptions=(KeyError,))
    def div(x):
        return 1 / x

    return div(0)


def test_caption_service_rerank_scores_match_jax(tmp_path, monkeypatch):
    import jax

    from avede_tpu.models.blip import init_blip
    from avede_tpu.models.blip import tiny_blip_config as jblip
    from avede_tpu.models.clip import init_clip
    from avede_tpu.models.clip import tiny_test_config as jclip
    from avede_tpu.parallel.embed import ClipEngine as JEngine
    from avede_tpu.parallel.mesh import build_mesh
    from avede_tpu.services.captioner import CaptionService as JCaption
    from avede_tpu_torch.models.blip import tiny_blip_config
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.models.convert import params_from_jax
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services.captioner import CaptionService

    _, clip = init_clip(jclip(), seed=0)
    _, blip = init_blip(jblip(), seed=0)
    jcap = JCaption(JEngine(cfg=jclip(), params=clip, mesh=build_mesh()),
                    cfg=jblip(), params=blip)
    tcap = CaptionService(
        ClipEngine(cfg=tiny_test_config(),
                   state_dict=params_from_jax(jax.tree.map(np.asarray, clip)),
                   device="cpu"),
        cfg=tiny_blip_config(),
        state_dict=params_from_jax(jax.tree.map(np.asarray, blip)))
    frames = np.random.default_rng(3).integers(0, 256, (3, 48, 64, 3),
                                               dtype=np.uint8)
    got, got_meta = tcap.rerank_scores(frames, "a white square")
    ref, ref_meta = jcap.rerank_scores(frames, "a white square")
    assert got_meta == ref_meta and len(got) == 3
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    again, _ = tcap.scores_from_repr(tcap.frame_repr(frames),
                                     "a white square")
    np.testing.assert_array_equal(got, again)


def test_fold_normalization_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    kernel = rng.normal(0, 0.02, (32, 32, 3, 64)).astype(np.float32)
    bias = rng.normal(0, 0.1, (64,)).astype(np.float32)
    k2, b2 = tpp.fold_normalization(torch.from_numpy(kernel),
                                    torch.from_numpy(bias))
    jk2, jb2 = jpp.fold_normalization(jnp.asarray(kernel), jnp.asarray(bias))
    np.testing.assert_array_equal(k2.numpy(), np.asarray(jk2))
    # each bias sums 3072 products in f32, in another order than XLA's
    np.testing.assert_allclose(b2.numpy(), np.asarray(jb2), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jb2)).max())
    # the fold is the normalisation: conv(norm(x)) == conv'(x)
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    norm = tpp._normalize(torch.from_numpy(x)).permute(0, 3, 1, 2)
    w = torch.from_numpy(kernel).permute(3, 2, 0, 1)
    ref = torch.nn.functional.conv2d(norm, w, torch.from_numpy(bias),
                                     stride=32)
    got = torch.nn.functional.conv2d(xt, k2.permute(3, 2, 0, 1), b2,
                                     stride=32)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
