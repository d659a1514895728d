"""job.evals: objective evaluations (value+grad and value-only) per job,
counted by the stage driver's wrapped objective."""


def read(rec):
    evals = [sum(u["evals"].values()) for u in rec.units if "evals" in u]
    return sum(evals) / len(evals) if evals else None
