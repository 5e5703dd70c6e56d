"""setup_s: seconds from the process's start to the first timed unit:
import, the kernel libraries' build (on a checkout's first run), the
server, the fill, the runner and mirrors, the capture and the warm
units. Host clock."""


def read(run):
    return run.setup_s
