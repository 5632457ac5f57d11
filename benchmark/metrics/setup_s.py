"""setup_s: seconds from the process's start to the window's opening:
imports, the kernels' build where a run finds them missing, the front
end, every client's placements and Router, and one warm run of each of
its jobs (host clock)."""


def read(run):
    return run.setup_s
