"""Polymorphic type registry for dict/YAML round-tripping.

Serializable framework objects (System elements, pupils, conjugates,
materials) carry a short "type" string in their dict form; `make`
turns such a dict back into the right class.  Behavioral parity with
reference name_mixin.py:22-71; each base class owns its own registry
dict.
"""

__all__ = ["NameMixin"]


class NameMixin:
    _default_type = None
    _nickname = None
    _type = None
    _typeletter = None

    @classmethod
    def register(cls, sub):
        """Class decorator: register `sub` under its `_type` string
        (defaulting to the lowercased class name) for `cls.make`."""
        if sub._type is None:
            sub._type = sub.__name__.lower()
        if "_registry" not in cls.__dict__:
            cls._registry = {}
        assert sub._type not in cls._registry, (cls, sub)
        cls._registry[sub._type] = sub
        return sub

    @classmethod
    def make(cls, data):
        """Instantiate from a plain dict (dispatching on its "type"
        key) or pass through an existing instance."""
        if isinstance(data, cls):
            return data
        kwargs = dict(data)
        typ = kwargs.pop("type", cls._default_type)
        return cls.__dict__["_registry"][typ](**kwargs)

    def dict(self):
        """Serializable form; the type tag is omitted when it is the
        default for the base class."""
        if self._type != self._default_type:
            dat = {"type": self._type}
        else:
            dat = {}
        if self._nickname:
            dat["nickname"] = self.nickname
        return dat

    type = property(lambda self: self._type)
    typeletter = property(
        lambda self: self._typeletter or self._type[0].upper())

    @property
    def nickname(self):
        return self._nickname or hex(id(self))

    @nickname.setter
    def nickname(self, name):
        self._nickname = name

    def __str__(self):
        return f"<{self.typeletter}/{self.nickname}>"
