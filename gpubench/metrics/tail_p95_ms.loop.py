"""tail_p95_ms.loop: the 95th percentile of the wall of every schedule of
the window (statistics.quantiles, exclusive method), in ms: schedule_p95_ms
read per layer, in the cells whose runs spread too widely on a shared host
for it to carry a bound end to end."""
import statistics


def read(run):
    w = [1e3 * x for x in run.walls]
    if len(w) < 2:
        return w[0] if w else None
    return statistics.quantiles(w, n=20)[18]
