"""The cotwin ("computational twin") problem container.

Reference: `greyjack/src/cotwin/cotwin.rs:12-57`. Planning entities and
problem facts are grouped by name; a score calculator (plain or incremental)
is attached by the user's cotwin builder. The TPU build compiles this
container into dense arrays once (`ScoreRequester`), after which solving
never touches Python objects.
"""


class Cotwin:
    def __init__(self):
        self.planning_entities = {}
        self.problem_facts = {}
        self.score_calculator = None

    def add_planning_entities(self, group_name, entities):
        self.planning_entities[group_name] = list(entities)

    def add_problem_facts(self, group_name, facts):
        self.problem_facts[group_name] = list(facts)

    def add_score_calculator(self, score_calculator):
        self.score_calculator = score_calculator
