"""Video decode, clip writing, embedding cache, frame retention."""
