"""medium_roofline_pct: the medium step's share of its byte bound over the
traced call: the bound (_medium_bytes.py: 105 B a live lane inside a
medium, from the program's counter `medium_lanes`, and 5 B a pool lane of
every wave, from RegenIntegrator.last_waves) at 3.35 TB/s, an H100 SXM at
700 W, over the device time of the wave stage `medium` (its marks, as
stage_ms.medium reads them), in percent. None where the trace holds no
such mark or the program publishes no such counter. Moves frame_ms."""
from portbench.metrics._medium_bytes import medium_bound_s
from portbench.metrics._stages import render_stages


def read(run):
    lanes = (run.get("counters") or {}).get("medium_lanes")
    waves = run.get("waves")
    if lanes is None or not waves:
        return None
    got = render_stages(run)
    if got is None or not got["stages"].get("medium"):
        return None
    return 100.0 * medium_bound_s(lanes, waves) / (
        got["stages"]["medium"] / 1e3)
