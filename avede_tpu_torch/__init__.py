"""AVEDE-TPU, PyTorch/CUDA port.

The second package of the repository, beside the JAX reference
``avede_tpu``. It follows the reference's layout and module names, so
each module here has its counterpart there, and it imports ``torch``,
numpy and the standard library only — never JAX, Flax or any module of
``avede_tpu``.

The port serves the ``mvp`` text query: decode → host I420 pack →
device unpack → fused patch embed (hand-written CUDA) → CLIP ViT-B/32
with flash attention (hand-written CUDA) → int8 embedding cache → text
tower → fused cosine score + window top-k (hand-written CUDA).

Entry points (``ClipEngine``, ``Phase1Scan``, ``VideoProcessor``,
``api.app.create_app``) run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no ``device="cpu"`` they raise.
"""

__version__ = "0.1.0"
