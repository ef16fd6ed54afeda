"""The session's reads of the card's results a frame, each of which
blocks the host on the stream: its stages that end in one (the recorder's
``SYNCS``: every ``wait`` stage and the copies down) over the frames of
the untraced window, from the port's stage records
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    calls = spans.window(run)
    if calls is None:
        return None
    syncs = spans.recorder()[0].SYNCS
    return sum(s.name in syncs for c in calls
               for s in c.stages) / spans.frames(run)
