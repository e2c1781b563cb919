"""Device time of the host-to-device copies a request, ms: every copy
whose name holds ``HtoD`` (the packed frames' transfer, the transfer
codec's cost on the card) over the traced window's finished requests.
Nothing when no such copy ran."""

from benchmark.metrics_common import device_s


def read(ctx):
    done = sum(r.ok for r in ctx.records)
    busy = device_s(ctx.events, ("htod",))
    if done == 0 or busy == 0:
        return None
    return 1e3 * busy / done
