"""The end-to-end rates, over whole requests and whole steps."""


def completed_rate(records, start: float, seconds: float, unit: str):
    """(rate, the records counted): the ``unit`` of every record that ended
    inside the window [start, start + seconds], over the time from the
    window's start to the end of the last of them. A record cut off by the
    window's end counts neither in the numerator nor in the time."""
    done = [r for r in records if r["end"] - start <= seconds]
    if not done:
        return None, done
    return sum(r[unit] for r in done) / (max(r["end"] for r in done) - start), done


def steps_rate(steps: int, batch: int, start: float, end: float) -> float:
    """Samples of ``steps`` whole steps of ``batch`` over the time from the
    window's start to a synchronize after the last of them."""
    return steps * batch / (end - start)
