"""The host time a job inside the program's host-wait spans
(``sdt.wait.<site>``), from the traced window, ms.

In a window of jobs back to back on a busy card this is the queue the host
drains at its waits, about the card's time a job less the host's issue
time: the host's lead over the card, not a cost.  It falls as the card
gets faster or the host slower, and reads 0 where the host paces the card
or blocks in its launches in place of a wait."""

from portbench.program_spans import waits_per_job


def read(ctx):
    return waits_per_job(ctx, "host_ms")
