"""Source providers: which file-based relations can be indexed, and how
they are signed, recorded in the log and reloaded at refresh
(counterpart of hyperspace_tpu/sources/)."""
