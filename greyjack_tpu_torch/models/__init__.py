"""Problem model families ported so far: vrp (multi-depot CVRP(-TW),
HardMediumSoftScore)."""
