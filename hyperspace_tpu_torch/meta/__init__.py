from .entry import (
    Content,
    Directory,
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    LogEntry,
    LogicalPlanFingerprint,
    Relation,
    Signature,
    Source,
    SourcePlan,
    Update,
)
from .log_manager import IndexLogManager
from .data_manager import IndexDataManager
from .path_resolver import PathResolver

__all__ = [
    "Content", "Directory", "FileIdTracker", "FileInfo", "IndexLogEntry", "LogEntry",
    "LogicalPlanFingerprint", "Relation", "Signature", "Source", "SourcePlan", "Update",
    "IndexLogManager", "IndexDataManager", "PathResolver",
]
