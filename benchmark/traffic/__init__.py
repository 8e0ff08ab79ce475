"""Traffic: the device renderer and the generator that reads a mix."""
