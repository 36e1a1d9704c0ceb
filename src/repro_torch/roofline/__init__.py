"""Roofline accounting on the H100: its published peaks and the bound."""
