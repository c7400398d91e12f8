"""Every proof whose verdict reached the host in the window, over the
window's seconds: from the first dispatch after warm-up to the last verdict
that arrived once `--seconds` had passed."""


def read(obs):
    recs = obs["records"]
    if not recs:
        return None
    return len(recs) * obs["batch"] / (recs[-1]["done"] - recs[0]["due"])
