"""Sparse operand formats and node reordering."""
