"""The snippet matcher and the host-side matcher seams of the port."""
