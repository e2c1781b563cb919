#!/usr/bin/env python3
"""The bf16 flash entry's long-sequence rows of ``chip_smoke.py`` phase 3,
alone: a quick check of both flash kernels on the card.

    python3 tools/flash_rows.py

Builds the kernels, then prints one JSON object a line: the card's name
and power limit, rows 2c (BLIP-base, [30, 577, 12, 64], fused qkv), 2d
(OWL-ViT B/32, [16, 577, 12, 64]), 2i (BLIP-2's ViT-g, [30, 257, 16,
88], fused qkv) and the edge row ([1, 193, 5, 88]) as phase 3 builds
them (each held to the plain version within one bf16 ulp + 1e-5, device
ms of the routed kernel, of the ``mma.sync`` kernel on the same inputs
and of SDPA), then phase 3's crossover sweep of the two kernels. Exits
non-zero on a failed check. Needs a card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    from avede_tpu_torch.ops import _build

    print(json.dumps({"card": cs.card_line(),
                      "built": sorted(_build.build_all())}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [cs.check_blip_flash(torch, F, dev, gen),
            cs.check_blip_flash(torch, F, dev, gen, cs.BLIP2_FLASH,
                                cs.BLIP2_TOKENS, 16, 88),
            cs.check_blip_flash(torch, F, dev, gen, cs.EDGE_FLASH,
                                cs.EDGE_TOKENS, 5, 88, bsz=1),
            cs.check_blhd_flash(torch, F, dev, gen, cs.OWL_FLASH,
                                cs.DETECTION_BATCH, cs.OWL_TOKENS)]
    for row in rows:
        print(json.dumps({k: row.get(k) for k in (
            "name", "kernel", "ms", "mma_ms", "library_ms", "bound_ms",
            "plain_ms", "max_abs_err", "tol_excess", "not_bit_equal")}),
            flush=True)
    print(json.dumps({"flash_crossover": cs.flash_crossover(
        torch, F, dev, gen)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
