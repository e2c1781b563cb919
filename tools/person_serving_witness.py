#!/usr/bin/env python3
"""Which of training and serving moves the ``person`` eval mode's rank
metrics between an H100 and the CPU.

    python3 tools/person_serving_witness.py

Needs a CUDA card and exits with 1 without one. The mode's protocol
(``avede_tpu_torch.eval.eval_person``, seed 0) runs three times: twice
trained on the card (training there is not bit-reproducible, so each is
its own draw), once trained on the CPU in f32 (deterministic). Each set
of trained weights is served on the same drawn data by the card in its
compute dtype (bf16) and by the CPU in f32 and in bf16. Prints the
card's name and power limit from ``nvidia-smi``, then one JSON line per
(training, serving) pair: the margins, the face detector's IoU, the
precision, frame precision and recall at k, and the fitted fusion
weights.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

KEYS = ("identity_margin", "face_margin", "face_detector_iou",
        "person_precision_at_k", "person_frame_precision_at_k",
        "person_recall_at_k", "fusion_weights_learned")
SERVE = (("cuda", "bfloat16"), ("cpu", "float32"), ("cpu", "bfloat16"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from avede_tpu_torch.eval import eval_person

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for run, trained_on in enumerate(("cuda", "cuda", "cpu")):
        t0 = time.perf_counter()
        out = eval_person(0, device=trained_on, serve=SERVE)
        for served in out["served_on"]:
            print(json.dumps({
                "run": run, "trained_on": trained_on,
                "served_on": served["device"], "dtype": served["dtype"],
                **{k: served[k] for k in KEYS},
                "run_wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
