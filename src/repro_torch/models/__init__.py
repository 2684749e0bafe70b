"""Model layers and the LM decode stack of the port."""
