from .expr import Avg, Col, Count, Max, Min, Sum, col, lit

__all__ = ["Avg", "Col", "Count", "Max", "Min", "Sum", "col", "lit"]
