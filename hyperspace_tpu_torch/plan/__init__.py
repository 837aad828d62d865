from .expr import Avg, Col, Count, Expr, Lit, Max, Min, Sum, col, lit
from .nodes import (
    Aggregate,
    BucketSpec,
    BucketUnion,
    FileScan,
    Filter,
    InMemoryScan,
    Join,
    Limit,
    LogicalPlan,
    Project,
    RepartitionByExpr,
    Sort,
    Union,
)
from .dataframe import DataFrame, DataFrameReader

__all__ = [
    "Avg", "Col", "Count", "Expr", "Lit", "Max", "Min", "Sum", "col", "lit",
    "Aggregate", "BucketSpec", "BucketUnion", "FileScan", "Filter",
    "InMemoryScan", "Join", "Limit", "LogicalPlan", "Project",
    "RepartitionByExpr", "Sort", "Union", "DataFrame", "DataFrameReader",
]
