"""Host reads per frame of the window: every synchronising call the run
made, counted with torch.cuda.set_sync_debug_mode("warn"), over the
frames the window completed."""


def read(obs):
    if obs.get("host_reads") is None or not obs.get("frames"):
        return None
    return obs["host_reads"] / obs["frames"]
