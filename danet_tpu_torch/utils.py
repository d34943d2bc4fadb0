"""Interactive console helpers: the reference's yes / no and overwrite
prompts.

Counterpart of ``danet_tpu/utils.py`` (reference ``app/utils.py:11-50``),
copied because the port imports nothing of the JAX package.
"""
from __future__ import annotations


def prompt_yesno(question: str) -> bool:
    """Blocking yes/no console prompt: asks until the answer is 'Y' (True)
    or 'n' (False)."""
    while True:
        action = input(question + " [Y]es [n]o : ")
        if action == "Y":
            return True
        if action == "n":
            return False


def prompt_overwrite(filename: str) -> str:
    """The file name to write: ``filename``, created empty, when it does
    not exist; else the answer to overwrite ('Y': ``filename``), abort
    ('n': '') or write a copy ('c': the first free ``filename.<i>``,
    created empty)."""
    try:
        f = open(filename, "x")
    except FileExistsError:
        while True:
            action = input(
                "file %s exists, overwrite? [Y]es [n]o [c]opy : " % filename)
            if action == "Y":
                return filename
            if action == "n":
                return ""
            if action == "c":
                i = 0
                while True:
                    new_filename = "%s.%d" % (filename, i)
                    try:
                        f = open(new_filename, "x")
                    except FileExistsError:
                        i += 1
                        continue
                    f.close()
                    return new_filename
    else:
        f.close()
        return filename
