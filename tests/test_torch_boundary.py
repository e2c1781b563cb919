"""The port's boundary: it imports no JAX, Flax or ``avede_tpu`` module;
its entry points refuse to run without a card unless asked for the CPU;
``chip_smoke.py`` fails, printing no result, where there is no card or
no repository beside it."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import avede_tpu_torch
names = [m.name for m in pkgutil.walk_packages(avede_tpu_torch.__path__,
                                                "avede_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "jaxlib", "avede_tpu")
             or m.startswith(("jax.", "flax.", "jaxlib.", "avede_tpu.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _run(args, cwd, env=None, timeout=240):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax_or_reference_package():
    res = _run(["-c", _IMPORT_ALL], cwd=ROOT)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "avede_tpu_torch.api.app" in out["modules"]
    for mod in ("pipelines.phase1", "pipelines.phase2", "pipelines.phase3",
                "models.blip", "models.univtg", "services.captioner",
                "utils.trace", "ops.boxes", "ops.nms", "ops.hostops",
                "ops.image_stats", "models.yolo", "models.owlvit",
                "services.detector", "services.adaptive_threshold",
                "services.universal_detector",
                "services.open_vocab_matcher", "parallel.scheduler",
                "services.cross_domain_matcher", "services.image_matcher",
                "pipelines.phase4", "models.qformer", "models.appearance",
                "services.person_detector", "utils.synthetic",
                "web.builtin", "parallel.optim", "parallel.train",
                "parallel.train_reid", "eval"):
        assert f"avede_tpu_torch.{mod}" in out["modules"]
    assert out["bad"] == []


def test_chip_smoke_imports_no_jax_or_reference_package():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            mod = words[1].split(".")[0]
            assert mod not in ("jax", "flax", "jaxlib", "avede_tpu"), line


class TestEntryPointsNeedACard:
    @pytest.fixture(autouse=True)
    def no_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_engine_raises(self):
        from avede_tpu_torch.parallel.embed import ClipEngine
        from avede_tpu_torch.utils.errors import ConfigurationError

        with pytest.raises(ConfigurationError, match="device='cpu'"):
            ClipEngine()
        with pytest.raises(ConfigurationError):
            ClipEngine(device="cuda")

    def test_scan_and_processor_raise(self):
        from avede_tpu_torch.pipelines.phase1 import Phase1Scan
        from avede_tpu_torch.services.video_processor import VideoProcessor
        from avede_tpu_torch.utils.errors import ConfigurationError

        with pytest.raises(ConfigurationError):
            Phase1Scan()
        with pytest.raises(ConfigurationError):
            VideoProcessor()

    def test_detectors_raise(self):
        from avede_tpu_torch.services.detector import YoloService
        from avede_tpu_torch.utils.errors import ConfigurationError

        with pytest.raises(ConfigurationError):
            YoloService()
        with pytest.raises(ConfigurationError):
            YoloService(device="cuda")

    def test_reranker_and_person_models_raise(self):
        from avede_tpu_torch.models.appearance import AppearanceEmbedder
        from avede_tpu_torch.models.qformer import tiny_qformer_config
        from avede_tpu_torch.services.captioner import Blip2RerankService
        from avede_tpu_torch.utils.errors import ConfigurationError

        with pytest.raises(ConfigurationError):
            Blip2RerankService(cfg=tiny_qformer_config())
        with pytest.raises(ConfigurationError):
            AppearanceEmbedder()

    def test_app_processor_raises(self, tmp_path, monkeypatch):
        from avede_tpu_torch.api.app import create_app
        from avede_tpu_torch.utils.config import settings
        from avede_tpu_torch.utils.errors import ConfigurationError

        for attr in ("DATA_DIR", "VIDEO_DIR", "CLIP_DIR", "FRAME_DIR",
                     "EMBEDDING_DIR", "IMAGE_DIR", "LOG_DIR"):
            monkeypatch.setattr(settings, attr, str(tmp_path / attr))
        app = create_app()
        with pytest.raises(ConfigurationError):
            app["state"].processor

    def test_trainers_and_eval_raise(self):
        from avede_tpu_torch import eval as teval
        from avede_tpu_torch.models.clip import tiny_test_config
        from avede_tpu_torch.parallel.train import (
            create_grounding_train_state, create_train_state)
        from avede_tpu_torch.parallel.train_reid import \
            create_reid_train_state
        from avede_tpu_torch.utils.errors import ConfigurationError

        with pytest.raises(ConfigurationError, match="device='cpu'"):
            create_train_state()
        with pytest.raises(ConfigurationError):
            create_train_state(tiny_test_config(), device="cuda")
        with pytest.raises(ConfigurationError):
            create_grounding_train_state()
        with pytest.raises(ConfigurationError):
            create_reid_train_state()
        with pytest.raises(ConfigurationError):
            teval.eval_grounding(steps=1, n_seeds=1)
        with pytest.raises(ConfigurationError):
            teval.main(["--mode", "grounding"])

    def test_cpu_on_request_runs(self):
        from avede_tpu_torch.models.clip import tiny_test_config
        from avede_tpu_torch.parallel.embed import ClipEngine

        eng = ClipEngine(cfg=tiny_test_config(), device="cpu")
        assert eng.device.type == "cpu"
        assert eng.embed_texts("a dog").shape == (1, 32)


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = _run([str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = _run(["chip_smoke.py"], cwd=tmp_path, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
