"""Cross-domain (colour ↔ grayscale, lighting-invariant) matching (copy
of ``avede_tpu/services/cross_domain_matcher.py``).

CLAHE on cv2's L channel, then four handcrafted feature families from
``ops/image_feats.py`` (LBP, HOG, edge and texture statistics) compared
by cosine similarity, and ORB keypoint matching at 500 and 1000
features, fused with the weights lbp .25, hog .25, orb .15, orb2 .15,
edges .1, texture .1. All on the host; cv2 is imported inside the
function that calls it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops import image_feats as F
from ..utils.logging import get_logger

logger = get_logger(__name__)

FUSION_WEIGHTS = {"lbp": 0.25, "hog": 0.25, "orb": 0.15, "orb2": 0.15,
                  "edges": 0.10, "texture": 0.10}


class CrossDomainMatcher:
    @staticmethod
    def normalize_lighting(image: np.ndarray) -> np.ndarray:
        """CLAHE (clip limit 2, 8 × 8 tiles) on the L channel."""
        import cv2

        if image.ndim == 2:
            clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
            return clahe.apply(image)
        lab = cv2.cvtColor(image, cv2.COLOR_RGB2LAB)
        clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        lab[..., 0] = clahe.apply(lab[..., 0])
        return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)

    def extract_features(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        norm = self.normalize_lighting(image)
        return {
            "lbp": F.lbp_histogram(norm),
            "hog": F.hog_features(norm),
            "edges": F.edge_stats(norm),
            "texture": F.texture_stats(norm),
            "_image": norm,
        }

    def compute_similarity(self, img1: np.ndarray, img2: np.ndarray
                           ) -> Dict[str, float]:
        f1 = self.extract_features(img1)
        f2 = self.extract_features(img2)
        sims: Dict[str, float] = {}
        for k in ("lbp", "hog", "edges", "texture"):
            sims[k] = max(F.cosine_sim(f1[k], f2[k]), 0.0)
        orb_a, _ = F.orb_match_score(f1["_image"], f2["_image"], 500)
        orb_b, _ = F.orb_match_score(f1["_image"], f2["_image"], 1000)
        sims["orb"] = orb_a
        sims["orb2"] = orb_b
        total = sum(FUSION_WEIGHTS[k] * sims[k] for k in FUSION_WEIGHTS)
        sims["combined"] = float(total)
        return sims

    def match_against_frames(self, reference: np.ndarray,
                             frames: np.ndarray,
                             threshold: float = 0.5) -> List[Dict]:
        """→ {frame_index, similarity, breakdown} of each frame whose
        fused similarity is at least ``threshold``."""
        ref_feats = self.extract_features(reference)
        out = []
        for i, frame in enumerate(frames):
            f = self.extract_features(frame)
            sims = {k: max(F.cosine_sim(ref_feats[k], f[k]), 0.0)
                    for k in ("lbp", "hog", "edges", "texture")}
            orb_a, _ = F.orb_match_score(ref_feats["_image"], f["_image"], 500)
            orb_b, _ = F.orb_match_score(ref_feats["_image"], f["_image"], 1000)
            sims["orb"] = orb_a
            sims["orb2"] = orb_b
            combined = sum(FUSION_WEIGHTS[k] * sims[k]
                           for k in FUSION_WEIGHTS)
            if combined >= threshold:
                out.append({"frame_index": i,
                            "similarity": float(combined),
                            "breakdown": {k: float(v)
                                          for k, v in sims.items()}})
        return out
