from .primitives import bar_tets, box_tets

__all__ = ["bar_tets", "box_tets"]
