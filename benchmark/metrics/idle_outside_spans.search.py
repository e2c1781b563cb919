"""The share of the device's idle time in the traced window during
which no program span was open on any thread, %: idle that the
program's spans cannot explain (the harness, request building, thread
hand-offs). Writes the idle seconds by open program span to stderr."""

from benchmark.program_spans import idle_outside


def read(ctx):
    return idle_outside(ctx, "idle_outside_spans.search")
