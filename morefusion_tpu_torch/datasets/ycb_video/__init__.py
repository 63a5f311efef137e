"""YCB-Video tables of the port."""
