from .ops import bsgs_mac
