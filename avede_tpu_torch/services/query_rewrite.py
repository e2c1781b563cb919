"""Query normalization for better CLIP matching (copy of
``avede_tpu/services/query_rewrite.py``): verbs → present participle,
object synonyms collapsed, colors standardized, articles and filler
adverbs dropped, in one table-driven pass.
"""

from __future__ import annotations

import re
from typing import Dict

_VERB_MAP: Dict[str, str] = {
    "walk": "walking", "walks": "walking",
    "run": "running", "runs": "running",
    "jump": "jumping", "jumps": "jumping",
    "fall": "falling", "falls": "falling",
    "sit": "sitting", "sits": "sitting",
    "stand": "standing", "stands": "standing",
    "drive": "driving", "drives": "driving",
    "hit": "hitting", "hits": "hitting",
    "crash": "crashing", "crashes": "crashing",
}

_NOUN_MAP: Dict[str, str] = {
    "automobile": "car",
    "vehicle": "car",
    "pedestrian": "person",
    "individual": "person",
    "canine": "dog",
}

_COLOR_MAP: Dict[str, str] = {
    "dark blue": "navy",
    "light blue": "blue",
    "dark green": "green",
    "light green": "green",
}

_ARTICLES = {"a", "an", "the"}
_FILLERS = {"very", "really", "quite", "somewhat", "rather", "pretty"}

_COLOR_RE = re.compile(
    "|".join(rf"\b{re.escape(k)}\b" for k in _COLOR_MAP))


def preprocess_query(query: str) -> str:
    q = re.sub(r"\s+", " ", query.strip()).lower()
    q = _COLOR_RE.sub(lambda m: _COLOR_MAP[m.group(0)], q)
    out = []
    for word in q.split(" "):
        if word in _ARTICLES or word in _FILLERS:
            continue
        out.append(_VERB_MAP.get(word, _NOUN_MAP.get(word, word)))
    return " ".join(out)
