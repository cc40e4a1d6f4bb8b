"""Random-move and plain paths: every neighbour drawn is scored."""


def per_island_step(config, args):
    return int(args["neighbours_count"])
