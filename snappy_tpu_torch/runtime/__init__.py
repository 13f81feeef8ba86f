"""The port's runtime: batching, host staging and the device codec."""
