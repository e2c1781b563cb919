"""Mean host wall of the device index a search in the traced window,
ms: every K' round of ``DeviceLibraryIndex.search`` (the query's
upload, the scan's launch under the lock, the wait for it and the
readback, locating the rows). From the program's ``index.search``
spans."""

from benchmark.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "index.search", "library.search")
