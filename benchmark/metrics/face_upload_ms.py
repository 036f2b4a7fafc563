"""face_upload_ms: ms a rebuild in the program's ``face_upload`` span, the
copies of the face table and the Neumann flags to the device."""
from benchmark.recorder import span_ms


def read(run):
    return span_ms(run, "face_upload")
