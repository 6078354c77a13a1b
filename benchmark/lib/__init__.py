"""The harness's own code: manifest, measurement, FLOP counts, guards."""
