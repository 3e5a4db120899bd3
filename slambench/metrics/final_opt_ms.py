"""final_opt_ms: host ms of one sequence's end: its blocking optimize
and the 5-level evaluation protocol (a benchmark span, ended by the
protocol's own reads of the card)."""


def read(rec):
    return rec.mean_ms("final_opt")
