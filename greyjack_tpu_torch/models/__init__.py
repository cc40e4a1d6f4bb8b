"""Problem model families ported so far: vrp (multi-depot CVRP(-TW),
HardMediumSoftScore) and mixedint (continuous / mixed-integer benchmark
objectives, SimpleScore)."""
