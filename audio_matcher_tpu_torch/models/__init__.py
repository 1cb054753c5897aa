"""Host-side matcher seams of the port."""
