"""The HicedrnDiff backbone and its building blocks."""
