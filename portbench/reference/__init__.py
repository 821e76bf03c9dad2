"""The plain reference of a render (plain torch and numpy)."""
