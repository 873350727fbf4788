"""The dynamic engine against the sync oracle on the constant 50/50 table:
every step splits or absorbs about half the lanes, so children spawn
children across many generations.

One case per integrator x collision model x boundary x draw protocol
(engine_cases.MATRIX); each must match the oracle bit for bit.
"""

import pytest

from engine_cases import (
    BASE,
    MATRIX_IDS,
    MATRIX_KW,
    assert_engine_matches_sync,
)


@pytest.mark.parametrize("kw", MATRIX_KW, ids=MATRIX_IDS)
def test_engine_matches_sync_const(const_table, kw):
    metrics = assert_engine_matches_sync(BASE.replace(**kw), const_table)
    assert sum(m["added"] + m["removed"] for m in metrics) > 0  # churn
