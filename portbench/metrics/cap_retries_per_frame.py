"""Cap retries a frame: K1's launches over the run's calls, less one a
call, over their frames.  A call whose layout or op sizes overflow the
session's caps grows them and runs K1 to K3 again."""


def read(run):
    if not run.n_frames or not run.launches:
        return None     # no counters to read
    return (run.launches.get("place", 0) - run.n_calls) / run.n_frames
