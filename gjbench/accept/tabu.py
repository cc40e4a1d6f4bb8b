"""TabuSearch's acceptance (`agents/tabu_search.py`): the step keeps its
best candidate iff that candidate's score is no worse than the base's,
lexicographically; on the sweep path also where the island has gone
`sweep_stall_limit` steps without a new best (the stall escape).

keeps(win_row, base_row, pre_state, i, builder): the two score rows by
the reference, the island states' tensors before the step, the island,
and the agent's settings."""

from gjbench.reference import common


def keeps(win_row, base_row, pre_state, i, builder):
    stall = pre_state.get("sweep_stall")
    limit = builder.get("sweep_stall_limit")
    if stall is not None and limit is not None and int(stall[i]) >= limit:
        return True
    return common.lex_leq(win_row, base_row)
