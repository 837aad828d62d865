from .tpch import TPCH_QUERIES, generate_tpch, tpch_indexes

__all__ = ["TPCH_QUERIES", "generate_tpch", "tpch_indexes"]
