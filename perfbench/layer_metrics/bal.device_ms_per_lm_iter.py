"""Device time per LM iteration of the traced solve: the union of the
card's operations over one whole solve (perfbench.trace), over its LM
iterations. The host's clock and launches move the window's rate; this
reads the card's work alone, so it is the steadier of the two."""


def read(obs):
    tr = obs.get("trace")
    if not tr or tr["busy_s"] <= 0 or not obs.get("lm_iterations"):
        return None
    return 1000.0 * tr["busy_s"] / obs["lm_iterations"]
