"""Output frames delivered per second in a closed loop: every frame
yielded in the window over the seconds from the window's start to the
last of them. Host clock."""


def read(run):
    d = run.delivery
    if d.frames == 0 or d.t_last <= d.t0:
        return None
    return d.frames / (d.t_last - d.t0)
