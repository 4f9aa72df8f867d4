"""Mean wall time of a window BA on the per-frame path over the window,
from the program's Monitor timer "local_BA" (it synchronises the card
before it stops)."""


def read(obs):
    ms = obs.get("local_ba_ms")
    return sum(ms) / len(ms) if ms else None
