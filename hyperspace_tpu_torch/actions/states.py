"""Index FSM states (counterpart of hyperspace_tpu/actions/states.py)."""

ACTIVE = "ACTIVE"
CREATING = "CREATING"
DELETED = "DELETED"
DOESNOTEXIST = "DOESNOTEXIST"

STABLE_STATES = frozenset({ACTIVE, DELETED, DOESNOTEXIST})
