"""Host reads per LM iteration of the traced solve: every synchronising
call it made, counted with torch.cuda.set_sync_debug_mode("warn"), over
its LM iterations."""


def read(obs):
    reads = (obs.get("traced") or {}).get("host_reads")
    if reads is None or not obs.get("lm_iterations"):
        return None
    return reads / obs["lm_iterations"]
