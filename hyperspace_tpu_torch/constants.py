"""Conf keys and defaults the port's query path reads.

Counterpart of hyperspace_tpu/constants.py: the same key strings, so a conf
dict written for the JAX package means the same thing here. Every key of
the JAX package's is carried over. One default differs on purpose: the
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

# lineage: with it on, an index records per row the stable id of its source
# file in DATA_FILE_NAME_ID, so deleted source files can be dropped
INDEX_LINEAGE_ENABLED = "hyperspace.index.lineage.enabled"
INDEX_LINEAGE_ENABLED_DEFAULT = False
DATA_FILE_NAME_ID = "_data_file_id"

# hybrid scan: serve an index whose source gained or lost files, within
# these byte ratios
HYBRID_SCAN_ENABLED = "hyperspace.index.hybridscan.enabled"
HYBRID_SCAN_ENABLED_DEFAULT = False
HYBRID_SCAN_MAX_APPENDED_RATIO = "hyperspace.index.hybridscan.maxAppendedRatio"
HYBRID_SCAN_MAX_APPENDED_RATIO_DEFAULT = 0.3
HYBRID_SCAN_MAX_DELETED_RATIO = "hyperspace.index.hybridscan.maxDeletedRatio"
HYBRID_SCAN_MAX_DELETED_RATIO_DEFAULT = 0.2

# the filter rule's rewritten scan carries the index's bucket spec (which
# then enters the plan fingerprint and makes the side bucketed for a join)
FILTER_RULE_USE_BUCKET_SPEC = "hyperspace.index.filterRule.useBucketSpec"
FILTER_RULE_USE_BUCKET_SPEC_DEFAULT = False

OPTIMIZE_FILE_SIZE_THRESHOLD = "hyperspace.index.optimize.fileSizeThreshold"
OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT = 256 * 1024 * 1024  # 256 MB
OPTIMIZE_MODE_QUICK = "quick"
OPTIMIZE_MODE_FULL = "full"
OPTIMIZE_MODES = (OPTIMIZE_MODE_QUICK, OPTIMIZE_MODE_FULL)

REFRESH_MODE_INCREMENTAL = "incremental"
REFRESH_MODE_FULL = "full"
REFRESH_MODE_QUICK = "quick"
REFRESH_MODES = (REFRESH_MODE_INCREMENTAL, REFRESH_MODE_FULL, REFRESH_MODE_QUICK)

INDEX_CACHE_EXPIRY_SECONDS = "hyperspace.index.cache.expiryDurationInSeconds"
INDEX_CACHE_EXPIRY_SECONDS_DEFAULT = 300

EXEC_TPU_ENABLED = "hyperspace.tpu.exec.enabled"
EXEC_TPU_ENABLED_DEFAULT = True
EXEC_EXACT_F64_AGG = "hyperspace.tpu.exec.exactF64Aggregates"
EXEC_EXACT_F64_AGG_DEFAULT = False
# devices a supported fragment runs over (0 = one device): rows shard across
# the mesh and only per-group partial vectors cross between devices
EXEC_MESH_DEVICES = "hyperspace.tpu.exec.meshDevices"
EXEC_MESH_DEVICES_DEFAULT = 0
# meshDevices arranged as (meshSlices, devices per slice) with ("dcn", "ici")
# axes: aggregates fold within each slice first, then across slices; index
# builds exchange rows within each slice only (one run per slice per bucket)
EXEC_MESH_SLICES = "hyperspace.tpu.exec.meshSlices"
EXEC_MESH_SLICES_DEFAULT = 1

INDEX_STATS_COLUMNS = "hyperspace.tpu.index.statsColumns"
INDEX_STATS_COLUMNS_DEFAULT = "clustered"
INDEX_COMPRESSION = "hyperspace.tpu.index.compression"
INDEX_COMPRESSION_DEFAULT = "lz4"
# index data files as parquet (default) or Arrow IPC (".arrow": uncompressed,
# memory-mapped reads, no row-group statistics); readers go by extension
INDEX_FORMAT = "hyperspace.tpu.index.format"
INDEX_FORMAT_DEFAULT = "parquet"

# index builds and refreshes whose source exceeds this many bytes stream
# through it in file groups of at most this size (out of core)
BUILD_MAX_BYTES_IN_MEMORY = "hyperspace.tpu.build.maxBytesInMemory"
BUILD_MAX_BYTES_IN_MEMORY_DEFAULT = 2 * 1024 * 1024 * 1024  # 2 GB

# z-order covering: the source bytes per data file, and percentile fields
# (else min-max) with the quantiles' relative error
ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION = "hyperspace.index.zorder.targetSourceBytesPerPartition"
ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION_DEFAULT = 1024 * 1024 * 1024  # 1 GB
ZORDER_QUANTILE_ENABLED = "hyperspace.index.zorder.quantile.enabled"
ZORDER_QUANTILE_ENABLED_DEFAULT = False
ZORDER_QUANTILE_RELATIVE_ERROR = "hyperspace.index.zorder.quantile.relativeError"
ZORDER_QUANTILE_RELATIVE_ERROR_DEFAULT = 0.01

# data skipping: the reference's index-data file size and count keys (read
# by neither package's build), and a PartitionSketch per partition column
# of a partitioned source, added to a data-skipping index's sketches
DATASKIPPING_TARGET_INDEX_DATA_FILE_SIZE = "hyperspace.index.dataskipping.targetIndexDataFileSize"
DATASKIPPING_TARGET_INDEX_DATA_FILE_SIZE_DEFAULT = 256 * 1024 * 1024
DATASKIPPING_MAX_INDEX_DATA_FILE_COUNT = "hyperspace.index.dataskipping.maxIndexDataFileCount"
DATASKIPPING_MAX_INDEX_DATA_FILE_COUNT_DEFAULT = 10000
DATASKIPPING_AUTO_PARTITION_SKETCH = "hyperspace.index.dataskipping.autoPartitionSketch"
DATASKIPPING_AUTO_PARTITION_SKETCH_DEFAULT = True

# sources: the provider classes (dotted names), the default provider's
# formats, the reader's declared glob pattern and the scan option that
# records a relation's glob scope
FILE_BASED_SOURCE_BUILDERS = "hyperspace.index.sources.fileBasedBuilders"
DEFAULT_SOURCE_FORMATS = "hyperspace.index.sources.defaultFileBasedSource.supportedFileFormats"
DEFAULT_SOURCE_FORMATS_DEFAULT = "avro,csv,json,orc,parquet,text"
GLOBBING_PATTERN_KEY = "hyperspace.source.globbingPattern"
OPT_GLOB_PATHS = "globPaths"

# telemetry: the event logger's class path (the JAX package's logger class
# names map to the port's, telemetry/logger.py)
EVENT_LOGGER_CLASS = "hyperspace.telemetry.eventLoggerClass"

# explain and whyNot: the display mode and the highlight tags that override
# the mode's own when both are set
DISPLAY_MODE = "hyperspace.explain.displayMode"
DISPLAY_MODE_DEFAULT = "plaintext"
HIGHLIGHT_BEGIN_TAG = "hyperspace.explain.displayMode.highlight.beginTag"
HIGHLIGHT_END_TAG = "hyperspace.explain.displayMode.highlight.endTag"

# a struct column's leaf reads as a flat column of this prefix and its path
NESTED_FIELD_PREFIX = "__hs_nested."

# log id offsets of the two-phase action protocol
LOG_ID_TRANSIENT_OFFSET = 1
LOG_ID_FINAL_OFFSET = 2
