"""CLIP towers, transformer layers, tokenizer, weight bridge."""
