"""The model work of each traffic kind, counted from the configuration's
file and the cell's shapes: floating-point operations and least bytes, and
the chip's published peaks they are held against.  Nothing here reads what
the port ran: a change that removes work leaves these counts as they are.
"""
