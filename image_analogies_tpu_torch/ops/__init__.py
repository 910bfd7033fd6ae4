"""Host and device ops of the port."""
