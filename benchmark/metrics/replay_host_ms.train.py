"""Mean host ms inside a `Trainer.train_step_staged` call in the window:
the enqueue of a replay."""


def read(run):
    ms = run.spans.durations_ms("train_step_staged")
    return sum(ms) / len(ms) if ms else None
