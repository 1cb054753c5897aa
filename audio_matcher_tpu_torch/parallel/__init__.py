"""The resident scanner of the port (one or more query snippets)."""
