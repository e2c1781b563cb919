"""The Kimi-VL caption cell at tiny sizes on the CPU: a sound run reads
``correct`` true, and faults planted in the program read it false at
the committed limits; ``roofline_kimi``'s counts against a hand count;
``moe_gemm_roofline`` on a synthetic trace."""

import numpy as np
import pytest

from benchmark import harness, roofline, roofline_kimi
from benchmark.program_spans import Span

CELL = "kimi-vl.caption.cold30"
SEED = 2 ** 31 + 2024


def _run(bench):
    return harness.run_cell(bench, CELL, SEED, 0.3, False, "cpu", 0.0)


def test_a_sound_tiny_run_is_correct_and_close(tiny):
    r = _run(tiny)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    c = {k: v["value"] for k, v in r["checks"].items()}
    # the program in f32 on the CPU against the f32 reference
    assert c["logit_gap"] < 1e-4 and c["score_gap"] < 1e-5
    assert c["route_gap"] == 0 and c["bad_outputs"] == 0


def _shift_one_layer(monkeypatch):
    """One MoE layer's (the last's) routed choices moved to the next
    expert."""
    from avede_tpu_torch.ops import moe

    real = moe.route
    calls = {"n": 0}

    def shifted(h, gate_w, bias, top_k, scale, n_shared):
        r = real(h, gate_w, bias, top_k, scale, n_shared)
        calls["n"] += 1
        if calls["n"] % 2 == 0:                 # the tiny cut's 2nd MoE
            e = gate_w.shape[0]
            slots = r.slots.clone()
            slots[:, :top_k] = (slots[:, :top_k] + 1) % e
            return moe.Routing(slots, r.weights)
        return r

    monkeypatch.setattr(moe, "route", shifted)


def _no_shared(monkeypatch):
    from avede_tpu_torch.ops import moe

    real = moe.route
    monkeypatch.setattr(moe, "route", lambda h, g, b, k, s, n:
                        real(h, g, b, k, s, 0))


def _unrotated_decode_rope(monkeypatch):
    """The rotary part of the latent cache written unrotated at decode."""
    from avede_tpu_torch.models import kimi_vl

    real = kimi_vl.MLA._rotate_latent

    def rot(self, k_pe, cos, sin):
        return k_pe if k_pe.shape[1] == 1 else real(self, k_pe, cos, sin)

    monkeypatch.setattr(kimi_vl.MLA, "_rotate_latent", rot)


def _swapped_vision_axes(monkeypatch):
    from avede_tpu_torch.models import kimi_vl

    real = kimi_vl.grid_positions
    monkeypatch.setattr(kimi_vl, "grid_positions",
                        lambda gh, gw, dev: real(gh, gw, dev)[::-1])


def _swapped_captions(monkeypatch):
    from avede_tpu_torch.services.captioner import KimiVLCaptionService

    real = KimiVLCaptionService.frame_repr

    def swap(self, frames, return_details=False):
        out = real(self, frames, return_details)
        caps = out[0] if return_details else out
        caps[0], caps[1] = caps[1], caps[0]
        return out

    monkeypatch.setattr(KimiVLCaptionService, "frame_repr", swap)


@pytest.mark.parametrize("fault", [_shift_one_layer, _no_shared,
                                   _unrotated_decode_rope,
                                   _swapped_vision_axes, _swapped_captions],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_reads_incorrect(tiny, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(tiny)
    assert r["failed"] == 0 and not r["correct"], r["checks"]


def test_roofline_counts_by_hand(tiny):
    cfg = tiny.cell(CELL).config
    # tiny: MoonViT 64 wide, 2 layers, MLP 96, patch 4 on a 4 x 8 grid
    length = 32
    layer = 2 * length * (64 * 192 + 64 * 64 + 2 * 64 * 96) \
        + 4 * length ** 2 * 64
    conv = 2 * length * 48 * 64
    assert roofline_kimi.moonvit_flops(cfg, 3) == 3 * (conv + 2 * layer)
    # projector: 8 tokens of 256 → 256 → 64
    assert roofline_kimi.projector_flops(cfg, 1) == 2 * 8 * (256 * 256
                                                             + 256 * 64)
    # a decoder token: MLA 64 → 4·24, 64 → 40, 32 → 4·32, 64 → 64; the
    # dense layer 3·64·96, an MoE layer its router (64 → 8) and 3 + 2
    # experts of 3·64·32
    mla = 2 * (64 * 96 + 64 * 40 + 32 * 128 + 64 * 64)
    dense, sparse = mla + 6 * 64 * 96, mla + 2 * 64 * 8 + 5 * 6 * 64 * 32
    p = 36
    attn = 4 * p * p * (24 + 16)
    assert roofline_kimi.prefill_flops(cfg, 2, p) == 2 * (
        p * (dense + 2 * sparse) + 3 * attn + 2 * 64 * 512)
    t = p + 1                   # one decode step at position p
    step_attn = 2 * 4 * (16 * 32 + 40 * t + t * 32 + 32 * 16)
    assert roofline_kimi.decode_flops(cfg, 1, p, 1) == (
        dense + 2 * sparse + 3 * step_attn + 2 * 64 * 512)
    assert roofline_kimi.expert_flops(cfg, 10) == 10 * 6 * 64 * 32
    assert roofline_kimi.expert_bytes(cfg, 10) == 10 * 3 * 64 * 32 * 2
    assert roofline_kimi.moonvit_flash_bound_s(cfg, 5) == \
        2 * roofline.flash_bound_s(5, 4, 32, 16)


def test_moe_gemm_roofline_is_100_where_the_kernels_take_the_bound(
        tiny, monkeypatch):
    cell = tiny.cell(CELL)
    cfg = cell.config
    spans = [Span(1, 0, 1, 0, "kimi.prefill", 0, 10, {"assignments": 5000}),
             Span(2, 0, 2, 0, "kimi.decode", 10, 20,
                  {"experts_touched": 300, "steps": 5})]
    need = (roofline.bound_s(flops=roofline_kimi.expert_flops(cfg, 5000))
            + roofline.bound_s(nbytes=roofline_kimi.expert_bytes(cfg, 300)))
    ns = int(round(need * 1e9))
    events = [("void grouped_kernel<Cfg<128>>", 0, ns // 2),
              ("void grouped_kernel<Cfg<16>>", ns // 2, ns),
              ("combine_kernel", ns, ns + 999)]
    ctx = harness.Context(cell, harness.Window(0, 1, []), events, ns / 1e9, 1)
    reader = tiny.reader("moe_gemm_roofline")
    monkeypatch.setattr(reader, "window_spans", lambda c: spans)
    got = reader.read(ctx)
    assert got == pytest.approx(100.0 * need / (ns / 1e9))
    assert np.isfinite(got) and got <= 100.0 + 1e-6
    # no grouped kernel in the trace (a program without it): nothing
    ctx.events[:] = events[2:]
    assert reader.read(ctx) is None
