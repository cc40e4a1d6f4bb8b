"""Entity reflection surface.

Reference contract: `CotwinEntityTrait::to_vec() -> Vec<(String,
CotwinValueTypes)>` (`greyjack/src/cotwin/cotwin_entity_trait.rs:5-7`). In
Python no enum wrapper is needed: an attribute value that is a
GJFloat/GJInteger instance is a planning variable; anything else (int,
float, bool, str) is a problem-fact column value (the reference's
`PAV(AnyValue)`, `cotwin_value_types.rs:8-12`).
"""


class CotwinEntity:
    """Optional base class; any object with `to_vec()` works."""

    def to_vec(self):
        """Return [(attribute_name, value)] in a stable column order.

        Default implementation reflects over `__dict__` insertion order.
        """
        return list(self.__dict__.items())
