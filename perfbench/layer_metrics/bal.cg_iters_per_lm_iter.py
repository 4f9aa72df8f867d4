"""CG iterations per LM iteration over the window's solves, from the
program's own counter (SnavelyResult.cg_iters of each solve)."""


def read(obs):
    if obs.get("cg_iters") is None or not obs.get("solves") or not obs.get("lm_iterations"):
        return None
    return obs["cg_iters"] / (obs["solves"] * obs["lm_iterations"])
