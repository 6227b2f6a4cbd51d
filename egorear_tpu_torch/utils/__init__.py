"""Host-side helpers: logging and the skeleton mesh export."""
