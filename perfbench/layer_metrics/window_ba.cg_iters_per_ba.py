"""CG iterations per window BA over the window, from the program's own
counters (MonoVO.n_cg_iters, n_window_ba)."""


def read(obs):
    if not obs.get("window_ba") or "cg_iters" not in obs:
        return None
    return obs["cg_iters"] / obs["window_ba"]
