"""Utilities of the port."""


def not_ported(owner: str, **flags) -> None:
    """Raise ``NotImplementedError`` for the first argument of ``owner``
    whose flag is true: it was set to something the port cannot do yet."""
    for name, is_set in flags.items():
        if is_set:
            raise NotImplementedError(
                f"{owner}: {name} is not ported to taper_tpu_torch yet "
                f"(ROADMAP.md, Queue 1)")
