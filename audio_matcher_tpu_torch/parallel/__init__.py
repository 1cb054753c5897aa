"""The batch scanner of the port."""
