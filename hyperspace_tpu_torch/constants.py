"""Conf keys and defaults the port's query path reads.

Counterpart of hyperspace_tpu/constants.py: the same key strings, so a conf
dict written for the JAX package means the same thing here. Only the keys
this slice reads are carried over. One default differs on purpose: the
device tier (``hyperspace.tpu.exec.enabled``) is ON, because the port's
device tier runs on the card by default.
"""

APPLY_ENABLED = "hyperspace.apply.enabled"
APPLY_ENABLED_DEFAULT = True

SYSTEM_PATH = "hyperspace.system.path"  # default: <warehouse>/indexes
INDEXES_DIR = "indexes"
HYPERSPACE_LOG = "_hyperspace_log"
LATEST_STABLE_LOG = "latestStable"
INDEX_VERSION_DIR_PREFIX = "v__"

INDEX_NUM_BUCKETS = "hyperspace.index.numBuckets"
INDEX_NUM_BUCKETS_LEGACY = "hyperspace.num.buckets"
INDEX_NUM_BUCKETS_DEFAULT = 8

# lineage column name: never written by this slice (lineage builds are not
# ported), but hidden from index scans of indexes that carry it
DATA_FILE_NAME_ID = "_data_file_id"

INDEX_CACHE_EXPIRY_SECONDS = "hyperspace.index.cache.expiryDurationInSeconds"
INDEX_CACHE_EXPIRY_SECONDS_DEFAULT = 300

EXEC_TPU_ENABLED = "hyperspace.tpu.exec.enabled"
EXEC_TPU_ENABLED_DEFAULT = True
EXEC_EXACT_F64_AGG = "hyperspace.tpu.exec.exactF64Aggregates"
EXEC_EXACT_F64_AGG_DEFAULT = False

INDEX_STATS_COLUMNS = "hyperspace.tpu.index.statsColumns"
INDEX_STATS_COLUMNS_DEFAULT = "clustered"
INDEX_COMPRESSION = "hyperspace.tpu.index.compression"
INDEX_COMPRESSION_DEFAULT = "lz4"

# log id offsets of the two-phase action protocol
LOG_ID_TRANSIENT_OFFSET = 1
LOG_ID_FINAL_OFFSET = 2
