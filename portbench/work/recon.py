"""Work of the recon loss's decode on one rank for one step: ``rows`` node
rows decoded through the drawn chromosome's decoder (d x ``width``) against
their target rows.  ``rows`` counts the rows that carry weight, those of
the step's nodes off the drawn chromosome (the loss weights each row by its
token count, so no other row enters the loss or its gradients); a decode of
every row of the rank's block (``decoded``) spends the rest on rows it
multiplies by nought.  Operations: the decode product forward and the two
of its backward, 3 x 2 x rows x d x width.  Bytes: the target block (rows x
width in the table's dtype) and the node rows (rows x d, bfloat16) read
once; the loss and the gradients, a scalar and (rows + width) x d, are
left out."""


def work(call: dict):
    rows, width, d, elem = call["rows"], call["width"], call["d"], call["elem"]
    return 6 * rows * d * width, rows * width * elem + rows * d * 2
