"""Built-in problem model families (counterpart of `greyjack_tpu/models/`,
the reference's `examples/` as a library):

  * nqueens  — N-Queens, SimpleScore (`examples/nqueens`)
  * tsp      — traveling salesman, HardSoftScore (`examples/tsp`)
  * vrp      — multi-depot CVRP(-TW), HardMediumSoftScore (`examples/vrp`)
  * mixedint — continuous / mixed-integer benchmark functions for LSHADE
"""
