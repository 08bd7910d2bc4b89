"""What decides ``correct``: each number that the cell's kind compares
(``kinds/<kind>.py``'s ``compare``), and the harness's own
``host_copy_mismatch`` where the audio goes to the host (elements of the
last host buffers that differ from the outputs they were copied from),
held to the limit that the configuration's ``limits`` states for it."""


def judge(numbers, limits, failed):
    """({name: (value, limit)}, blocks that failed) of the comparison; a
    run whose blocks all passed but whose other numbers did not counts
    one failure."""
    numbers = {k: (v, float(limits[k])) for k, v in numbers.items()}
    if failed == 0 and not passed(numbers):
        failed = 1
    return numbers, failed


def passed(numbers):
    """Every number within its limit (a NaN is not)."""
    return all(v <= lim for v, lim in numbers.values())
