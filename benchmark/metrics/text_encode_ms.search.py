"""Mean host wall of the text tower a search in the traced window, ms:
``ClipEngine.embed_texts`` on a text-LRU miss (tokenize, upload, the
tower's launches, the embedding back on the host); a hit adds nothing.
From the program's ``clip.encode_text`` spans."""

from benchmark.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "clip.encode_text", "library.search")
