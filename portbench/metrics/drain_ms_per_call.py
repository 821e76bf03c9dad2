"""drain_ms_per_call: device ms of the traced call's drain, its waves
narrower than the pool: the last waves[P/4] + waves[P/16] waves of the
call (RegenIntegrator.last_waves, the program's counter, over-run waves
included), each wave's device ms from its `respawn` mark to its `end` mark
(_stages.py). The call launches every counted wave, so the trace holds as
many waves as the counter; a run where they differ gives None. Moves
frame_ms."""
from portbench.metrics._stages import render_stages


def read(run):
    waves = run.get("waves")
    got = render_stages(run)
    if not waves or got is None:
        return None
    widths = {int(w): int(n) for w, n in waves.items()}
    if len(got["wave_ms"]) != sum(widths.values()):
        return None
    narrow = sum(n for w, n in widths.items() if w < max(widths))
    return float(sum(got["wave_ms"][len(got["wave_ms"]) - narrow:]))
