"""Host ms a traced call spends in the recover stages (the sign recurrence
and the back-transform, which wait for the card nowhere): the program's
``stage/recover/*`` spans.

Read in the top-k cells only.  After a stage that leaves the card a long
queue (the solve's kernel 1), the sign loop's launches fill the launch
queue and the host blocks in ``cudaLaunchKernel``, so there the spans time
the card's backlog, not the host's issue."""

from bench import program_trace


def read(record: dict):
    return program_trace.span_ms(record, "stage/recover")
