"""The share of the traced window in which the device is idle while the
host is inside spectral3d's `spectral3d.constants` span (a host-side
constant build: `make_ops`, `_dft_tables`, `_hermitian_weights`): the
idle time the constants cost. Idle inside the spans is the union of the
spans and the device records less the union of the records alone, so
each instant counts once however many records or spans cover it. None
where the program has no such span (it reads 0 where it has one and the
window holds none) or the window holds no device record."""

from port_bench.harness.trace import union_us

LAYER = "solver step loop"
UNIT = "%"
SOURCE = "program_span"
MOVES = "cell_updates_per_s"


def read(ctx):
    from ns_tpu_torch.solvers import spectral3d

    name = getattr(spectral3d, "CONSTANTS_SPAN", None)
    tr = ctx.trace
    if name is None or not tr.device:
        return None
    busy = [(ts, ts + dur) for _, ts, dur, _, _ in tr.device]
    spans = [(a, b) for a, b, _ in tr.spans(name)]
    idle_in_spans = (union_us(spans + busy, tr.t0, tr.t1)
                     - union_us(busy, tr.t0, tr.t1))
    return 100.0 * idle_in_spans / (tr.t1 - tr.t0)
